"""The Montgomery product of csrc/field.cuh (fe_mul), on Python integers.

fe_mul is a CIOS over 8 x 32-bit words written as PTX carry chains, with
the running sum split into an even and an odd half and no ninth or tenth
word (the no-carry form that the moduli's spare bits allow).  No CUDA
compiler runs here, so the product is checked two ways on the CPU:

- `model_fe_mul` is a word-level model of it, step for step: the first
  round's products, each round's two product chains (the odd half moved
  back up a word), its two reduction chains, the halves swapping roles
  after each round, the final merge and the one conditional subtraction.
  It asserts that every carry the device code drops is 0 and that the
  running sum stays below 2p.
- `header_fe_mul` runs the asm statements of field.cuh themselves, parsed
  from the header (instruction by instruction, carry flag and all), in
  fe_mul's order of calls.

Both are held, limb for limb (tolerance 0: integer arithmetic), against the
JAX package's product (zklaim_tpu.ff.montgomery.mont_mul, jit on the CPU)
and the port's plain version (ff/montgomery.py:mont_mul_plain), for Fq and
Fr, on seeded random pairs and on every pair of the edge values 0, 1,
R mod p, p - 1, p - 2 and values whose top word is p's, 0x30644e72
(kernels/cases.py:field_edge_values, on which the card's K1 is held to
its plain version too).
"""

import re
from itertools import product
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from zklaim_tpu.ff import limbs as JL
from zklaim_tpu.ff import montgomery as JM

from zklaim_tpu_torch.ff import montgomery as TM
from zklaim_tpu_torch.ff.limbs import ints_to_limbs, limbs_to_ints
from zklaim_tpu_torch.kernels.cases import field_edge_values

torch.set_num_threads(1)

HEADER = Path(TM.__file__).resolve().parent.parent / "csrc" / "field.cuh"
SRC = HEADER.read_text()
MASK = (1 << 32) - 1
SPECS = [(JM.FQ, TM.FQ), (JM.FR, TM.FR)]
IDS = ["Fq", "Fr"]


def _block(name: str) -> list:
    body = re.search(name + r"[^=]*=\s*\{(.*?)\};", SRC, re.S).group(1)
    return [int(h, 16) for h in re.findall(r"0x([0-9a-f]+)u", body)]


P_WORDS = [_block("ZK_P")[8 * f : 8 * f + 8] for f in range(2)]
NP = _block("ZK_NP")


def _words(x: int) -> list:
    return [(x >> (32 * j)) & MASK for j in range(8)]


def _int(words: list) -> int:
    return sum(w << (32 * j) for j, w in enumerate(words))


# ---------------------------------------------------------------------------
# the word-level model
# ---------------------------------------------------------------------------

def _half(x: int, part: str) -> int:
    return x & MASK if part == "lo" else x >> 32


def model_fe_mul(a: list, b: list, field_id: int) -> list:
    """fe_mul<F> on 8-word operands below p: 8 words below p."""
    p, np_ = P_WORDS[field_id], NP[field_id]
    pv = _int(p)

    def chain(words):
        """A carry chain over (product or 0, addend) pairs: returns the words
        and the carry out of the last one."""
        out, c = [], 0
        for prod, add in words:
            s = prod + add + c
            out.append(s & MASK)
            c = s >> 32
        return out, c

    def even_products(x, w, bi):
        """chain 2 / 4: x[j], x[j + 1] += w[j] bi for even j; the carry out"""
        terms = [(_half(w[j - j % 2] * bi, "hi" if j % 2 else "lo"), x[j]) for j in range(8)]
        new, c = chain(terms)
        x[:] = new
        return c

    def mul_round(e, o, bi):
        """e aligned, o one word down (o[k] at word k - 1, o[0] spent)"""
        s = e[0] + o[1]
        e[0], c = s & MASK, s >> 32
        new = []
        for k in range(8):        # chain 1: o[k] = o[k + 2] + a[k + 1] bi (lo / hi), from that carry
            x = _half(a[k + 1 - k % 2] * bi, "hi" if k % 2 else "lo") + (o[k + 2] if k + 2 < 8 else 0) + c
            new.append(x & MASK)
            c = x >> 32
        assert c == 0, "chain 1 dropped a carry out of word 8"
        o[:] = new
        o[7] += even_products(e, a, bi)                  # chain 2
        assert o[7] <= MASK, "chain 2's carry overflowed word 8"

    def redc_round(e, o):
        """e aligned, o one word up: t += m p, after which e[0] = 0"""
        m = (e[0] * np_) & MASK
        c = even_products(o, p[1:] + [0], m)             # chain 3: the odd words of p into o
        assert c == 0, "chain 3 dropped a carry out of word 8"
        o[7] += even_products(e, p, m)                   # chain 4
        assert o[7] <= MASK and e[0] == 0

    e = [_half(a[j - j % 2] * b[0], "hi" if j % 2 else "lo") for j in range(8)]
    o = [_half(a[j + 1 - j % 2] * b[0], "hi" if j % 2 else "lo") for j in range(8)]
    for i in range(8):
        if i:
            mul_round(e, o, b[i])
        redc_round(e, o)
        t = _int(e[1:]) + _int(o)                         # t / 2^32: the next round's sum
        assert t < 2 * pv, "the running sum left [0, 2p)"
        e, o = o, e                                      # the halves swap roles
    # e aligned, o one word down: merge, then subtract p once
    r, c = chain([(e[j], o[j + 1] if j < 7 else 0) for j in range(8)])
    assert c == 0
    v = _int(r)
    assert v < 2 * pv
    return _words(v - pv if v >= pv else v)


# ---------------------------------------------------------------------------
# field.cuh's own asm statements, run on Python integers
# ---------------------------------------------------------------------------

def _function_body(signature: str) -> str:
    start = SRC.index(signature)
    i = SRC.index("{", start)
    depth = 0
    for j in range(i, len(SRC)):
        depth += {"{": 1, "}": -1}.get(SRC[j], 0)
        if depth == 0:
            return SRC[i : j + 1]
    raise AssertionError(signature)


def _asm_statements(signature: str) -> list:
    """[(instructions, operand expressions, how many are '+r' outputs)] of
    each asm statement in a function of field.cuh."""
    out = []
    for stmt in re.findall(r"asm\((.*?)\);\s*\n", _function_body(signature), re.S):
        parts = stmt.split(":")
        template = "".join(re.findall(r'"((?:[^"\\]|\\.)*)"', parts[0])).replace("\\n\\t", "")
        instrs = [i.strip() for i in template.split(";") if i.strip()]
        ops, n_out = [], 0
        for section, is_out in ((parts[1], True), (parts[2] if len(parts) > 2 else "", False)):
            for cons, expr in re.findall(r'"([+=]?r)"\(([^()]*)\)', section):
                assert (cons == "+r") == is_out, (signature, cons)
                ops.append(expr.strip())
                n_out += is_out
        out.append((instrs, ops, n_out))
    return out


ASM = {name: _asm_statements(sig) for name, sig in (
    ("mul_round", "void cios_mul_round("),
    ("redc_round", "void cios_redc_round("),
    ("fe_mul", "Fe fe_mul("),
)}


def _ref(expr: str, env: dict):
    m = re.fullmatch(r"ZK_P\[F\]\[(\d)\]", expr)
    if m:
        return env["P"], int(m.group(1))
    m = re.fullmatch(r"(\w+)(?:\.v)?\[(\d)\]", expr)
    if m:
        return env[m.group(1)], int(m.group(2))
    return env, expr


def run_asm(statement, env: dict, dropped: list) -> None:
    """One asm statement: its operands read from env, its instructions run
    in order with a carry flag, its '+r' outputs written back.  A carry
    out of an instruction without .cc goes to `dropped`."""
    instrs, ops, n_out = statement
    refs = [_ref(x, env) for x in ops]
    regs = [box[key] for box, key in refs]
    cc = None                                    # no carry may come in from before the statement
    for ins in instrs:
        opcode, args = ins.split(None, 1)
        args = [a.strip() for a in args.split(",")]
        val = [regs[int(a[1:])] if a.startswith("%") else int(a) for a in args[1:]]
        parts = opcode.split(".")
        assert parts[-1] == "u32", ins
        carry_in = parts[0] in ("addc", "madc")
        if carry_in:
            assert cc is not None, f"{ins}: reads a carry no instruction of the statement set"
        if parts[0] in ("add", "addc"):
            s = val[0] + val[1]
        elif parts[0] in ("mad", "madc"):
            s = _half(val[0] * val[1], parts[1]) + val[2]
        else:
            raise AssertionError(f"unmodelled instruction {ins}")
        s += cc if carry_in else 0
        regs[int(args[0][1:])] = s & MASK
        if "cc" in parts:
            cc = s >> 32
        else:
            dropped.append(s >> 32)
            cc = None
    for (box, key), v in list(zip(refs, regs))[:n_out]:
        box[key] = v


def header_fe_mul(a: list, b: list, field_id: int, dropped: list) -> list:
    """fe_mul<F> as field.cuh runs it: the first round in C, the rounds'
    asm statements in fe_mul's order, the merge's asm statement, and
    fe_reduce_once (one subtraction of p where the result is >= p)."""
    p = P_WORDS[field_id]
    e = [_half(a[j - j % 2] * b[0], "hi" if j % 2 else "lo") for j in range(8)]
    o = [_half(a[j + 1 - j % 2] * b[0], "hi" if j % 2 else "lo") for j in range(8)]

    def redc(x, y):
        run_asm(ASM["redc_round"][0], {"e": x, "o": y, "P": p, "m": (x[0] * NP[field_id]) & MASK},
                dropped)

    for i in range(0, 8, 2):
        if i:
            run_asm(ASM["mul_round"][0], {"e": e, "o": o, "a": a, "bi": b[i]}, dropped)
        redc(e, o)
        run_asm(ASM["mul_round"][0], {"e": o, "o": e, "a": a, "bi": b[i + 1]}, dropped)
        redc(o, e)
    run_asm(ASM["fe_mul"][0], {"e": e, "o": o}, dropped)
    v = _int(e)
    return _words(v - _int(p) if v >= _int(p) else v)


# ---------------------------------------------------------------------------
# inputs and the two references
# ---------------------------------------------------------------------------

def _pairs(spec, seed: int, n_random: int = 48):
    rng = np.random.default_rng(seed)
    edges = field_edge_values(spec)
    assert {0, 1, spec.r_mod, spec.p - 1, spec.p - 2} <= set(edges)
    assert sum(x >> 224 == 0x30644E72 for x in edges) >= 4
    a, b = map(list, zip(*product(edges, edges)))
    for _ in range(n_random):
        w = rng.integers(0, 1 << 63, size=(2, 5)).tolist()
        x, y = ((v[0] | v[1] << 63 | v[2] << 126 | v[3] << 189 | v[4] << 252) % spec.p for v in w)
        a.append(x)
        b.append(y)
    return a, b


def _references(js, ts, a: list, b: list) -> list:
    la, lb = JL.ints_to_limbs(a), JL.ints_to_limbs(b)
    jax_out = jax.jit(JM.mont_mul, static_argnums=0)(js, jnp.asarray(la), jnp.asarray(lb))
    plain = TM.mont_mul_plain(ts, torch.from_numpy(ints_to_limbs(a).astype(np.int32)),
                              torch.from_numpy(ints_to_limbs(b).astype(np.int32)))
    np.testing.assert_array_equal(plain.numpy(), np.asarray(jax_out).astype(np.int32))
    return limbs_to_ints(plain.numpy())


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

def test_moduli_meet_the_no_carry_condition():
    """Parsed from field.cuh: each modulus' top word is below 2^31 - 1, so
    a round's sum (below 2^33 p) fits in nine words and the result (below
    2p) in eight."""
    for f, spec in enumerate((TM.FQ, TM.FR)):
        assert _int(P_WORDS[f]) == spec.p
        assert P_WORDS[f][7] == 0x30644E72 < (1 << 31) - 1
        assert (1 << 33) * spec.p < 1 << 288 and 2 * spec.p < 1 << 256
        assert (NP[f] * P_WORDS[f][0]) & MASK == MASK            # n' = -p^-1 mod 2^32


def test_fe_mul_is_one_carry_chain_product():
    """fe_mul is the chained product: no 64-bit accumulator, no word past
    the eighth, nothing read at run time that could pick another product."""
    body = _function_body("Fe fe_mul(")
    for name in ("cios_mul_round", "cios_redc_round"):
        text = _function_body(f"void {name}(")
        assert "mad.lo.cc.u32" in text and "madc.hi.cc.u32" in text and "uint64_t" not in text
    assert "uint64_t" not in body and "t[8]" not in body and "t[9]" not in body
    assert len(re.findall(r"\bFe fe_mul\(", SRC)) == 1
    assert not re.search(r"getenv|ZK_MUL|#if", SRC)
    assert [len(s[0]) for s in ASM["mul_round"] + ASM["redc_round"] + ASM["fe_mul"]] == [18, 17, 8]


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
def test_model_matches_jax_and_plain(specs):
    js, ts = specs
    a, b = _pairs(ts, 1 + ts.field_id)
    want = _references(js, ts, a, b)
    got = [_int(model_fe_mul(_words(x), _words(y), ts.field_id)) for x, y in zip(a, b)]
    assert got == want
    assert all(g == x * y * pow(1 << 256, -1, ts.p) % ts.p for g, x, y in zip(got, a, b))


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
def test_header_asm_matches_model_jax_and_plain(specs):
    """field.cuh's asm statements, run as written, give the product of the
    model and of both references, and every carry they drop is 0."""
    js, ts = specs
    a, b = _pairs(ts, 11 + ts.field_id, n_random=24)
    want = _references(js, ts, a, b)
    dropped = []
    got = [_int(header_fe_mul(_words(x), _words(y), ts.field_id, dropped)) for x, y in zip(a, b)]
    assert got == want
    assert got == [_int(model_fe_mul(_words(x), _words(y), ts.field_id)) for x, y in zip(a, b)]
    # a product drops two carries a round (7 product rounds, 8 reductions) and one in the merge
    assert len(dropped) == len(a) * (2 * 7 + 2 * 8 + 1) and not any(dropped)


def test_header_round_drops_a_carry_only_where_it_is_zero():
    """Out of range (a word 8 of 2^32 - 1 and a modulus of all ones) the
    header's reduction round does drop a carry: the run sees it, so the
    check above is not vacuous."""
    dropped = []
    run_asm(ASM["redc_round"][0], {"e": [MASK] * 8, "o": [MASK] * 8, "P": [MASK] * 8, "m": MASK},
            dropped)
    assert any(dropped)
