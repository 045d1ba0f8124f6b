"""claims/witness.py, the holder's compiled witness build, against the held
copy's (`ZKlaimCircuit.witness`): the same WitnessVec for ZKlaimCircuit(1)
and ZKlaimCircuit(3) on seeded and edge inputs, no hook run one by one, a
hook it cannot recognise run through its closure, and the same proof bytes
from Context.proof_generate as from the prover on the copy's witness.
(N = 20 stays out: its circuit alone takes about 16 s to build.)
"""

import random

import numpy as np
import pytest

import torch

from zklaim_tpu_torch.claims import api as TAPI
from zklaim_tpu_torch.claims.circuit import (
    OP_EQ, OP_GREATER_EQ, OP_LESS, OP_LESS_EQ, OP_NOOP, OP_NOT_EQ, ZKlaimCircuit)
from zklaim_tpu_torch.claims.witness import WitnessProgram, witness_program
from zklaim_tpu_torch.ec import curve as C
from zklaim_tpu_torch.ec.hostcurve import g1_generator, g2_generator
from zklaim_tpu_torch.ff.limbs import limbs_to_ints
from zklaim_tpu_torch.ff.params import R
from zklaim_tpu_torch.groth16 import api as G
from zklaim_tpu_torch.groth16.qap import QAP
from zklaim_tpu_torch.r1cs.system import LC
from zklaim_tpu_torch.utils.profiling import recording

torch.set_num_threads(1)

TOP = (1 << 64) - 1


@pytest.fixture(scope="module")
def circuits():
    return {n: ZKlaimCircuit(n) for n in (1, 3)}


def _payloads(seed, n, attrs=None, refs=None, ops=None):
    """n payloads (pre48, refs, ops): attributes in [2^20, 2^40), each
    reference its attribute plus -1, 0 or 1, random ops, unless given (a
    function of the payload and slot)."""
    rng = random.Random(seed)
    out = []
    for p in range(n):
        a = [attrs(p, k) if attrs else rng.randrange(1 << 20, 1 << 40) for k in range(5)]
        pre = b"".join(v.to_bytes(8, "little") for v in a) + rng.randbytes(8)
        r = [refs(p, k) if refs else a[k] + rng.choice((-1, 0, 1)) for k in range(5)]
        o = [ops(p, k) if ops else rng.randrange(OP_NOOP + 1) for k in range(5)]
        out.append((pre, r, o))
    return out


def _same(want, got):
    assert list(got) == list(want)
    assert got.big == want.big
    np.testing.assert_array_equal(got.to_plain_limbs(), want.to_plain_limbs())


CASES = {
    "seeded_n1": (1, {}),
    "seeded_n3": (3, {}),
    "attribute_equal_to_reference": (1, {"refs": lambda p, k: 1000 + k,
                                         "attrs": lambda p, k: 1000 + k}),
    "attribute_zero": (1, {"attrs": lambda p, k: 0, "refs": lambda p, k: k * 77}),
    "reference_top": (1, {"refs": lambda p, k: TOP}),
    "attribute_top": (1, {"attrs": lambda p, k: TOP, "refs": lambda p, k: [0, 1, TOP, TOP - 1, 5][k]}),
    "every_op_position": (3, {"ops": lambda p, k: (5 * p + k) % (OP_NOOP + 1)}),
    "failing_predicate": (3, {"attrs": lambda p, k: 50, "refs": lambda p, k: 40 + 5 * p,
                              "ops": lambda p, k: [OP_LESS, OP_LESS_EQ, OP_EQ, OP_EQ,
                                                   OP_NOT_EQ][k]}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_program_witness_is_the_copys(circuits, case):
    """Value for value: the small lane, the big values and their indices,
    the plain limbs; a failing predicate too (the prover rejects it later)."""
    n, kw = CASES[case]
    inputs = _payloads(sum(map(ord, case)), n, **kw)
    _same(circuits[n].witness(inputs), witness_program(circuits[n]).witness(inputs))


def _case_witness(circuits, case):
    n, kw = CASES[case]
    return witness_program(circuits[n]).witness(_payloads(sum(map(ord, case)), n, **kw))


def test_the_edge_cases_reach_their_edges(circuits):
    """z = inv = 0 in every comparison where the attribute is its reference;
    a witness with equal and unequal slots that satisfies its predicates
    (each unequal slot's inverse big) satisfies the system; the failing
    predicate's witness does not."""
    cs = circuits[1].cs
    pairs = [d[2] for d in cs.hook_descs if d[0] == "py" and len(d[2]) == 2]
    assert len(pairs) == 5
    equal = _case_witness(circuits, "attribute_equal_to_reference")
    assert all(equal[z] == equal[inv] == 0 for z, inv in pairs)
    mixed = witness_program(circuits[1]).witness(_payloads(
        5, 1, attrs=lambda p, k: 7, refs=lambda p, k: 7 + 2 * (k > 2),
        ops=lambda p, k: [OP_EQ, OP_LESS_EQ, OP_GREATER_EQ, OP_LESS, OP_NOT_EQ][k]))
    assert cs.is_satisfied(mixed)
    assert [mixed[z] for z, _ in pairs] == [0, 0, 0, 1, 1]
    assert [inv in mixed.big for _, inv in pairs] == [False, False, False, True, True]
    assert not circuits[3].cs.is_satisfied(_case_witness(circuits, "failing_predicate"))


@pytest.mark.parametrize("n", [1, 3])
def test_no_hook_runs_one_by_one(circuits, n):
    """Every `py` hook of the circuit is caught by a pass: the counter reads
    0 at each build (the copy runs 21 at N = 1, 61 at N = 3)."""
    program = witness_program(circuits[n])
    assert (program.py_hooks, program.copy_py_hooks) == (0, 20 * n + 1)
    with recording() as rec:
        program.witness(_payloads(n, n))
        program.witness(_payloads(n + 1, n))
    assert [(name, v) for _, name, v in rec.counts] == [("claims.witness_py_hooks", 0)] * 2


def test_an_unknown_hook_runs_through_its_closure():
    circuit = ZKlaimCircuit(1)
    cs = circuit.cs
    src, out = circuit._payload_bit_vars[0][0], cs.alloc()

    def hook(w, src=src, out=out, k=5):             # no pattern: w[out] = w[src] + 5
        w[out] = int(w[src]) + k

    cs.add_hook(hook, ("py", [src], [out]))
    program = WitnessProgram(circuit)
    assert program.steps is not None and program.py_hooks == 1
    inputs = _payloads(11, 1)
    with recording() as rec:
        got = program.witness(inputs)
    _same(circuit.witness(inputs), got)
    assert got[out] == got[src] + 5
    assert [(name, v) for _, name, v in rec.counts] == [("claims.witness_py_hooks", 1)]


def test_a_hook_shaped_like_a_pattern_but_not_its_values_runs_through_its_closure():
    """A closure holding (LC, z, out) as the comparison's `less` does, but
    computing OR: its trial against the `and` pass fails at the build, so it
    runs one by one and the others stay in their passes."""
    circuit = ZKlaimCircuit(1)
    cs = circuit.cs
    a = circuit._payload_bit_vars[0][0]
    out = cs.alloc()

    def hook(w, le=LC.of(a), z_var=a + 1, less_var=out):
        w[less_var] = le.eval(w) | int(w[z_var])

    cs.add_hook(hook, ("py", [a, a + 1], [out]))
    program = WitnessProgram(circuit)
    assert program.steps is not None and program.py_hooks == 1
    for seed in (12, 13, 14):
        inputs = _payloads(seed, 1)
        _same(circuit.witness(inputs), program.witness(inputs))


def test_the_program_is_built_once_per_circuit(circuits):
    assert witness_program(circuits[1]) is witness_program(circuits[1])
    assert witness_program(circuits[1]) is not witness_program(circuits[3])


def _linear_sums(pk, w_plain, h, msm_c=8):
    """groth16.api.prove_sums for a key whose i-th table point is (i + 1)
    times its generator (each sum a dot product, then one multiplication):
    every witness entry and H coefficient moves the proof."""
    aux = w_plain[pk.num_primary + 1:]

    def dot(rows):
        ints = limbs_to_ints(rows.numpy())
        return sum((i + 1) * v for i, v in enumerate(ints)) % R

    def planes(deg, scalars):
        gen = g1_generator() if deg == 1 else g2_generator()
        f = C.ops_for(deg)
        return C.point_to_planes(f, C.host_points_to_proj(f, [gen * s for s in scalars],
                                                          w_plain.device))

    return (planes(1, [dot(w_plain), 3 * dot(w_plain), dot(h), dot(aux)]),
            planes(2, [5 * dot(w_plain)]))


def test_proof_generate_gives_the_copys_proof_bytes(circuits, monkeypatch):
    """One seed at N = 1: Context.proof_generate's bytes are those of
    prove(pk, qap, circuit.witness(inputs), rng) on the same seeded rng."""
    from zklaim_tpu_torch.claims import serde

    monkeypatch.setattr(G, "prove_sums", _linear_sums)
    circuit = circuits[1]
    ctx = TAPI.Context("cpu")
    pl = TAPI.Payload()
    pl.set_attr(25, 0)
    pl.set_attr(40000, 1)
    pl.data_ref = [18, 50000, 0, 0, 0]
    pl.data_op = [TAPI.ZkOp.GREATER_OR_EQ, TAPI.ZkOp.LESS] + [TAPI.ZkOp.NOOP] * 3
    ctx.add_payload(pl)
    ctx.hash_payloads(random.Random(19))
    ctx._circuit_cache[1] = circuit
    qap = QAP.for_cs(circuit.cs, "cpu")
    g1, g2 = g1_generator(), g2_generator()
    pk = G.ProvingKey(qap.num_vars, qap.num_primary, qap.m, g1 * 2, g1 * 3, g1 * 5,
                      g2 * 3, g2 * 5, *([None] * 5))
    ctx.pk = b"ZKPK-primed"
    ctx._pk_cache = (ctx.pk, 1, pk, qap)
    assert ctx.proof_generate(random.Random(20)) == TAPI.ZKLAIM_OK
    inputs = [(pl.pre, pl.data_ref, pl.op_positions())]
    want = G.prove(pk, qap, circuit.witness(inputs), random.Random(20))
    assert ctx.proof == serde.proof_to_bytes(want)
