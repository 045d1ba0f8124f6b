"""The holder's witness build for a ZKlaimCircuit, as batched numpy passes.

claims/circuit.py, r1cs/system.py and gadgets/*.py are held copies of the
JAX package's modules, so the faster build lives here and is held to the
copy's witness (`circuit.witness`): the same WitnessVec, value for value.

The copy sets the payloads' input bits one at a time, then runs
`WitnessPlan`: the hooks in dependency levels, each level's `bitop` and
`dec` hooks as numpy batches and its `py` hooks as Python closures, one by
one (at N = 20, 402 closures: the multipacking of the public input bits
and three hooks of each 64-bit comparison).  A `WitnessProgram`, built
once per circuit, keeps the plan's levels and its `bitop` and `dec`
batches, sets the input bits with one `np.unpackbits` and one scatter, and
replaces each `py` batch by passes over the hooks it recognises from their
descriptor and the linear combinations their closure holds:

- pack: one output, a list of at most 253 bit operands; the output is
  sum bit_i 2^i (multipacking), packed with `np.packbits`;
- sub: a `decompose` of 2^m + P - N into m + 1 bits, P and N sums of
  distinct powers 2^k (k < m <= 64) of bit variables (a comparison's
  difference): the low m bits are (P - N) mod 2^m, bit m is [N <= P];
- nonzero: outputs z and inv of a sum S of distinct powers 2^k (k < 64) of
  bit variables: z = [S != 0], inv = S^-1 mod r (0 for S = 0);
- and: one output, a bit operand AND a bit variable (a comparison's less).

A pattern reads only variables known to hold bits: the input bits and the
outputs of `bitop`, `dec` and the bit-valued patterns.  A hook is taken
into a pass only where its closure, run on trial values of its inputs,
writes what the pass writes.  Any other hook runs through its closure at
its level; counter `claims.witness_py_hooks` adds, at each build, the hooks
it ran one by one (0 for ZKlaimCircuit).
"""

from __future__ import annotations

import itertools
import random
import threading

import numpy as np

from ..ff.params import FR_CAPACITY, R
from ..r1cs.system import LC, WitnessPlan, WitnessVec, bit_operand
from ..utils.profiling import count
from .circuit import ops_buffer, refs_buffer

_INPUT_BYTES = (48, 64, 64)     # a payload's preimage, refs and ops buffers
_BUILD = threading.Lock()


def witness_program(circuit) -> WitnessProgram:
    """The circuit's program: built at the first call, then kept on the
    circuit, so holders that share a circuit share it (read-only)."""
    with _BUILD:
        program = getattr(circuit, "_witness_program", None)
        if program is None:
            program = circuit._witness_program = WitnessProgram(circuit)
    return program


class WitnessProgram:
    """A ZKlaimCircuit's witness build: `witness(payload_inputs)` returns
    what `circuit.witness(payload_inputs)` returns."""

    def __init__(self, circuit):
        self.circuit = circuit
        cs = circuit.cs
        plan = cs.witness_plan()
        self.steps = None                   # None: every build runs the copy's
        self.copy_py_hooks = (len(cs.hooks) if plan is None else
                              sum(len(b[1]) for b in plan._batches if b[0] == "py"))
        self.py_hooks = self.copy_py_hooks  # the hooks a build runs one by one
        self._sizes = list(_INPUT_BYTES) * circuit.num_payloads
        if plan is None:
            return
        firsts = [v for group in circuit._payload_bit_vars for v in group]
        self._input_vars = np.concatenate(
            [np.arange(v, v + 8 * size) for v, size in zip(firsts, self._sizes)]
            or [np.zeros(0, np.int64)])

        is_bit = np.zeros(cs.num_vars, bool)
        is_bit[0] = is_bit[self._input_vars] = True
        is_bit[[d[3] for d in cs.hook_descs if d[0] == "bitop"]] = True
        for d in cs.hook_descs:
            if d[0] == "dec":
                is_bit[d[3]:d[3] + d[4]] = True
        trial = _Trial(cs.num_vars)
        found = {}                          # id of a hook -> (pass key, row)
        for fn, desc in zip(cs.hooks, cs.hook_descs):
            if desc[0] != "py":             # in order: a hook reads earlier hooks' outputs
                continue
            match = _recognise(fn, desc, is_bit)
            if match is not None and trial.agrees(fn, desc, *match[:2]):
                found[id(fn)] = match[:2]
                is_bit[match[2]] = True

        self.steps, plain, self.py_hooks = [], [], 0
        for batch in plan._batches:
            if batch[0] != "py":
                plain.append(batch)
                continue
            if plain:
                self.steps.append(_plan_of(plain, cs.num_vars).run)
                plain = []
            rows = {}
            for fn in batch[1]:
                key, row = found.get(id(fn), (("hooks",), fn))
                rows.setdefault(key, []).append(row)
            self.py_hooks += len(rows.get(("hooks",), ()))
            self.steps += [_PASSES[key[0]](group, *key[1:]) for key, group in rows.items()]
        if plain:
            self.steps.append(_plan_of(plain, cs.num_vars).run)

    def witness(self, payload_inputs):
        """The full assignment for a list of (pre48, data_refs, op_positions);
        counter claims.witness_py_hooks."""
        assert len(payload_inputs) == self.circuit.num_payloads
        parts = [b for pre, refs, ops in payload_inputs
                 for b in (pre, refs_buffer(refs), ops_buffer(ops))]
        if self.steps is None or [len(b) for b in parts] != self._sizes:
            count("claims.witness_py_hooks", self.copy_py_hooks)
            return self.circuit.witness(payload_inputs)
        w = WitnessVec(self.circuit.cs.num_vars)
        w.small[0] = 1
        w.small[self._input_vars] = np.unpackbits(np.frombuffer(b"".join(parts), np.uint8))
        for step in self.steps:
            step(w)
        count("claims.witness_py_hooks", self.py_hooks)
        return w


def _plan_of(batches, num_vars) -> WitnessPlan:
    """A WitnessPlan that runs these of the copy's batches."""
    plan = WitnessPlan.__new__(WitnessPlan)
    plan._batches, plan.num_vars = batches, num_vars
    return plan


class _Trial:
    """A recognised hook's closure against its pass, on trial values of the
    hook's inputs: every assignment of up to three inputs, else all zeros,
    all ones and two seeded random ones."""

    def __init__(self, num_vars):
        self.rng = random.Random(0)
        self.closure, self.batch = WitnessVec(num_vars), WitnessVec(num_vars)
        self.closure.small[0] = self.batch.small[0] = 1

    def agrees(self, fn, desc, key, row) -> bool:
        _, in_vars, outs = desc
        n = len(in_vars)
        trials = (list(itertools.product((0, 1), repeat=n)) if n <= 3 else
                  [[0] * n, [1] * n] + [[self.rng.getrandbits(1) for _ in range(n)]
                                        for _ in range(2)])
        run = _PASSES[key[0]]([row], *key[1:])
        for bits in trials:
            for w in (self.closure, self.batch):
                w.small[in_vars] = bits
                w.small[outs] = 0
                for v in outs:
                    w.big.pop(v, None)
            fn(self.closure)
            run(self.batch)
            if [self.closure[v] for v in outs] != [self.batch[v] for v in outs]:
                return False
        return True


# -- recognising a hook ---------------------------------------------------------


def _vars(*lcs):
    return sorted({v for lc in lcs for v in lc.terms if v})


def _powers(lc: LC, width: int, is_bit):
    """(const, P, N) of an LC const + sum_P 2^k x - sum_N 2^k x over bit
    variables x, no k twice in P or in N and every k below width (P and N
    as {k: (x, not negated)}, rows of `_table`); None for any other LC."""
    pos, neg = {}, {}
    for v, c in lc.terms.items():
        if v == 0:
            continue
        side, mag = (pos, c) if c <= R // 2 else (neg, R - c)
        k = mag.bit_length() - 1
        if mag != 1 << k or k >= width or k in side or not is_bit[v]:
            return None
        side[k] = v, 0
    return lc.terms.get(0, 0), pos, neg


def _recognise(fn, desc, is_bit):
    """(pass key, row, bit outputs) of a ("py", in_vars, outs) hook whose
    closure holds one of the patterns of the module's docstring, else None."""
    _, in_vars, outs = desc
    match getattr(fn, "__defaults__", None):
        case (int(out), list(chunk)) if outs == [out] and 0 < len(chunk) <= FR_CAPACITY:
            ops = [bit_operand(lc) if isinstance(lc, LC) else None for lc in chunk]
            if all(op is not None and is_bit[op[0]] for op in ops) and in_vars == _vars(*chunk):
                return ("pack",), (out, ops), []
        case (int(first), LC() as lc, int(n)) if outs == list(range(first, first + n)):
            split = _powers(lc, n - 1, is_bit) if 1 < n <= 65 else None
            if split is not None and split[0] == 1 << (n - 1) and in_vars == _vars(lc):
                return ("sub", n), (first, split[1], split[2]), outs
        case (LC() as s, int(z), int(inv)) if outs == [z, inv]:
            split = _powers(s, 64, is_bit)
            if split is not None and split[0] == 0 and not split[2] and in_vars == _vars(s):
                return ("nonzero",), (z, inv, split[1]), [z]
        case (LC() as le, int(z), int(out)) if outs == [out] and is_bit[z]:
            op = bit_operand(le)
            if op is not None and is_bit[op[0]] and in_vars == sorted(set(_vars(le)) | {z}):
                return ("and",), (out, op, z), outs
    return None


# -- the passes -----------------------------------------------------------------


def _table(rows, width):
    """(var, negated) gather table of bit operands, rows of {k: (var, neg)},
    the places not given the constant 0 (NOT w[0])."""
    var = np.zeros((len(rows), width), np.int64)
    neg = np.ones((len(rows), width), np.int64)
    for r, ops in enumerate(rows):
        for k, (v, n) in ops.items():
            var[r, k], neg[r, k] = v, n
    return var, neg


def _bits(small, table):
    var, neg = table
    return (small[var] ^ neg).astype(np.uint8)


def _u64(small, table):
    """Each row of a 64-wide table as the uint64 of its bits, LSB first."""
    return np.packbits(_bits(small, table), axis=1, bitorder="little").view("<u8")[:, 0]


def _pack_pass(rows):
    outs = [out for out, _ in rows]
    table = _table([dict(enumerate(ops)) for _, ops in rows], FR_CAPACITY)
    size = (FR_CAPACITY + 7) // 8

    def run(w):
        raw = np.packbits(_bits(w.small, table), axis=1, bitorder="little").tobytes()
        for r, out in enumerate(outs):
            w[out] = int.from_bytes(raw[r * size:(r + 1) * size], "little")
    return run


def _sub_pass(rows, n):
    m = n - 1
    plus = _table([pos for _, pos, _ in rows], 64)
    minus = _table([neg for _, _, neg in rows], 64)
    outs = np.array([range(first, first + n) for first, _, _ in rows], np.int64)
    shifts = np.arange(m, dtype=np.uint64)

    def run(w):
        p, q = _u64(w.small, plus), _u64(w.small, minus)
        w.small[outs[:, :m]] = ((p - q)[:, None] >> shifts) & np.uint64(1)
        w.small[outs[:, m]] = p >= q
    return run


def _nonzero_pass(rows):
    z = np.array([z for z, _, _ in rows], np.int64)
    inv = [inv for _, inv, _ in rows]
    table = _table([pos for _, _, pos in rows], 64)

    def run(w):
        s = _u64(w.small, table)
        w.small[z] = s != 0
        for var, x in zip(inv, s.tolist()):
            w[var] = pow(x, -1, R) if x else 0
    return run


def _and_pass(rows):
    out, var, neg, z = (np.array(c, np.int64) for c in zip(
        *[(out, v, n, z) for out, (v, n), z in rows]))

    def run(w):
        w.small[out] = (w.small[var] ^ neg) & w.small[z]
    return run


def _hooks_pass(fns):
    def run(w):
        for fn in fns:
            fn(w)
    return run


_PASSES = {"pack": _pack_pass, "sub": _sub_pass, "nonzero": _nonzero_pass,
           "and": _and_pass, "hooks": _hooks_pass}
