"""The benchmark's plain reference against the program, on the CPU: the
input map, its own build of the circuit and the QAP at tau, the keys it
works out from the setup's randomness, the textbook pairing, the byte
formats, and its refusal of tampered proofs, keys and signatures.

Run from the root of the repository:
    python -m pytest zkbench/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import random

import pytest
import torch

from zkbench.reference import credential as ref
from zkbench.reference import ed25519_ecdsa, zklaim_circuit
from zkbench.reference.bn254 import pairing

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny():
    """The program's verifying key and one proof of its small
    credential-shaped circuit on the CPU, and the proof's primary inputs."""
    from zklaim_tpu_torch.claims import serde
    from zklaim_tpu_torch.entry import tiny_circuit
    from zklaim_tpu_torch.groth16.api import prove, setup

    cs, witness = tiny_circuit()
    pk, vk, qap = setup(cs, random.Random("setup"), "cpu")
    proof = prove(pk, qap, witness, random.Random("prove"))
    return {"primary": list(witness[1 : cs.num_primary + 1]),
            "vk": serde.vk_to_bytes(vk), "proof": serde.proof_to_bytes(proof)}


def test_public_inputs_match_the_program():
    from zklaim_tpu_torch.claims.api import OP_TO_POSITION, ZkOp
    from zklaim_tpu_torch.claims.circuit import public_inputs_for

    rng = random.Random(7)
    for n in (1, 2, 3):
        payloads = [(rng.randbytes(32), [rng.randrange(1 << 64) for _ in range(5)],
                     [rng.choice(list(ZkOp)) for _ in range(5)]) for _ in range(n)]
        want = public_inputs_for([(h, refs, [OP_TO_POSITION[op] for op in ops])
                                  for h, refs, ops in payloads])
        assert ref.public_inputs([(h, refs, [int(op) for op in ops])
                                  for h, refs, ops in payloads]) == want


@pytest.mark.parametrize("num_payloads, counts", [
    (1, (27629, 25412, 6, 32768)), (2, (55257, 50822, 11, 65536))])
def test_the_circuit_is_the_programs(num_payloads, counts):
    """Row for row and wire for wire, the reference's ZKlaimCircuit(N) is
    the program's (the counts are zklaim's, PERF.md's configurations)."""
    from zklaim_tpu_torch.claims.circuit import ZKlaimCircuit

    cs = ZKlaimCircuit(num_payloads).cs
    mine = zklaim_circuit.circuit(num_payloads)
    assert (len(mine.rows), mine.num_vars, mine.num_primary,
            zklaim_circuit.domain_size(mine)) == counts
    assert (cs.num_vars, cs.num_primary) == (mine.num_vars, mine.num_primary)
    assert [(a.terms, b.terms, c.terms) for a, b, c in cs.constraints] == mine.rows


def test_column_evals_match_the_programs_qap():
    """A_j(tau), B_j(tau), C_j(tau) of every wire of ZKlaimCircuit(1), and
    Z(tau), equal the program's QAP instance map."""
    from zklaim_tpu_torch.claims.circuit import ZKlaimCircuit
    from zklaim_tpu_torch.groth16.qap import QAP

    tau = random.Random("tau").randrange(1, ref.R)
    at, bt, ct, z_tau = QAP.for_cs(ZKlaimCircuit(1).cs, "cpu").eval_at_tau(tau)
    cs = zklaim_circuit.circuit(1)
    got = zklaim_circuit.column_evals(cs, tau, range(cs.num_vars))
    assert got[3] == z_tau
    for mine, want in zip(got[:3], (at, bt, ct)):
        assert [mine[j] for j in range(cs.num_vars)] == want


def _setup(num_payloads: int, seed: str):
    """The program's issuer keys for ZKlaimCircuit(num_payloads) on the CPU."""
    from zklaim_tpu_torch.claims.api import Context

    ctx = Context("cpu")
    assert ctx.trusted_setup(random.Random(seed)) == 0
    return ctx.pk, ctx.vk


def test_keys_of_the_programs_setup(monkeypatch):
    """The program's keys are those the setup's randomness and the circuit
    give; keys of another seed, cut short, or of another circuit (one row
    more, which setup and prove would follow together) are caught."""
    from zklaim_tpu_torch.claims import api
    from zklaim_tpu_torch.r1cs.system import ONE

    pk, vk = _setup(0, "setup")
    keys = ref.reference_keys(0, random.Random("setup"), random.Random("rows"))
    assert keys["dims"] == {"num_payloads": 0, "num_vars": 1, "num_primary": 0, "m": 1,
                            "constraints": 0}
    assert ref.key_mismatches(pk, vk, keys) == []
    other = ref.reference_keys(0, random.Random("other"), random.Random("rows"))
    assert "alpha_g1" in ref.key_mismatches(pk, vk, other)
    assert ref.key_mismatches(pk[:-64], vk, keys)

    class OneRowMore(api.ZKlaimCircuit):
        def __init__(self, num_payloads):
            super().__init__(num_payloads)
            self.cs.constrain(ONE, ONE, ONE, "a row the reference does not have")

    monkeypatch.setattr(api, "ZKlaimCircuit", OneRowMore)
    assert "vk.ic[0]" in ref.key_mismatches(*_setup(0, "setup"), keys)


def test_the_pairing_is_bilinear_and_not_degenerate():
    g1, g2 = ref.g1_generator(), ref.g2_generator()
    assert pairing.pairing_product_is_one([(g1 * 6, g2 * 5), (-(g1 * 10), g2 * 3)])
    assert not pairing.pairing_product_is_one([(g1, g2)])


def test_proofs_verify_and_tampering_is_refused(tiny):
    """Alone and in a batch: the good proofs pass, each tampered one is
    refused, and a batch with one bad proof names it."""
    vk = ref.parse_vk(tiny["vk"])
    primary = tiny["primary"]
    proof = ref.parse_proof(tiny["proof"])
    a, b, c = proof
    g1 = ref.g1_generator()
    rng = random.Random("weights")
    assert ref.proofs_verify(vk, [(primary, proof)], rng) == [True]
    bad = [(primary, (a, b, c + g1)), (primary, (a + g1, b, c)),
           ([primary[0] + 1] + primary[1:], proof), (primary[1:], proof)]
    assert ref.proofs_verify(vk, bad, rng) == [False] * 4
    assert ref.proofs_verify(vk, [(primary, proof), bad[0], (primary, proof)], rng) == [
        True, False, True]
    flipped = bytearray(tiny["proof"])
    flipped[-1] ^= 1                                # C's y: off the curve
    with pytest.raises(ref.BadEncoding):
        ref.parse_proof(bytes(flipped))


def test_signature_and_presentation_bytes():
    from zklaim_tpu_torch.claims import signing
    from zklaim_tpu_torch.claims.api import Context, Payload

    rng = random.Random(3)
    priv = signing.keygen(rng)
    ctx = Context("cpu")
    for _ in range(2):
        pl = Payload()
        for pos in range(5):
            pl.set_attr(rng.randrange(1 << 40), pos)
        pl.data_ref, pl.data_op = [rng.randrange(1 << 64) for _ in range(5)], [1, 3, 2, 10, 99]
        ctx.add_payload(pl)
    ctx.hash_payloads(rng)
    ctx.vk = b"ZKVK" + bytes(40)
    ctx.sign(priv, rng)
    hashes = [pl.hash for pl in ctx.payloads]
    pub = signing.pk_to_pub(priv)
    assert ref.signature_verifies(hashes, ctx.vk, ctx.signature, pub)
    assert not ref.signature_verifies(hashes[::-1], ctx.vk, ctx.signature, pub)
    assert not ed25519_ecdsa.verify(b"x", ctx.signature, pub)

    ctx.proof = bytes(260)
    cred = {"hash": hashes, "signature": ctx.signature}
    claim = [(pl.data_ref, pl.data_op) for pl in ctx.payloads]
    issuer = {"vk": ctx.vk, "pub_key": pub}
    raw = ctx.serialize()
    assert not ref.presentation_matches(ref.parse_presentation(raw), cred, claim, issuer)
    ctx.clear_pres()
    pres = ref.parse_presentation(ctx.serialize())
    assert ref.presentation_matches(pres, cred, claim, issuer)
    assert pres["proof"] == bytes(260)
    claim[1][0][0] ^= 1
    assert not ref.presentation_matches(pres, cred, claim, issuer)
    with pytest.raises(ref.BadEncoding):
        ref.parse_presentation(ctx.serialize()[:-1])


def test_claim_holds():
    assert ref.claim_holds([[5, 5, 5, 5, 5]], [([6, 6, 5, 5, 4], [1, 3, 2, 10, 8])])
    assert ref.claim_holds([[5] * 5], [([4, 0, 0, 0, 0], [9, 99, 99, 99, 99])])
    assert not ref.claim_holds([[5] * 5], [([5, 0, 0, 0, 0], [1, 99, 99, 99, 99])])
