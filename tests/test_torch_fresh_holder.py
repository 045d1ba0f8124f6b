"""The cold holder of the reference's demo (zklaim/main.c:176-212) on the
port: a context deserialised from the issuer's wire bytes and handed the
pk's bytes proves once, importing the pk and building the circuit, its QAP
and its witness program on the way (claims.api.Context.proof_generate).
On the CPU at N = 0, the zero-payload flow's sizes (a 724-byte pk):

- its proof equals the same context's next proof, on the imported pk and
  the built circuit, under one seeded rng;
- the textbook check of zkbench/reference/credential.py (which imports
  nothing of the program) accepts it under the verifying key it works out
  from the setup's randomness, and refuses it altered;
- once the context is dropped, nothing keeps its pk tables or its QAP
  alive: reference counting frees them, with no collector run, so a
  holder a request gives the card's memory back at each drop;
- the cold proof's spans nest as the layers do and the pk's counters count
  once for the import, not for the warm proof.
"""

import gc
import random
import weakref

import pytest
import torch

from zkbench.reference import credential as ref
from zkbench.reference.bn254.hostcurve import g1_generator
from zklaim_tpu_torch.claims import signing
from zklaim_tpu_torch.claims.api import ZKLAIM_OK, Context
from zklaim_tpu_torch.utils.profiling import recording

torch.set_num_threads(1)
SETUP, PROVE = "fresh-holder/setup", "fresh-holder/prove"
PK_BYTES = 20 + 3 * 64 + 2 * 128 + 64 * 2 + 128      # one wire: a, b1, b2 rows; no h, no l
PK_POINTS = 5 + 3


@pytest.fixture(scope="module")
def cold():
    """The issuer's setup and wire bytes; a fresh holder's cold proof and
    its warm one (recorded); weak references to the holder's pk tables,
    QAP and circuit, read after the holder is dropped and again after a
    collector run."""
    rng = random.Random(22)
    issuer = Context("cpu")
    assert issuer.trusted_setup(random.Random(SETUP)) == ZKLAIM_OK
    issuer.sign(signing.keygen(rng), rng)
    with recording() as rec:
        holder, status = Context.deserialize(issuer.serialize(), "cpu")
        assert status == ZKLAIM_OK and holder.proof == b""
        holder.pk = issuer.pk
        statuses = [holder.proof_generate(random.Random(PROVE))]
        cold_proof = holder.proof
        statuses.append(holder.proof_generate(random.Random(PROVE)))
    _, _, pk, qap = holder._pk_cache
    refs = {name: weakref.ref(obj) for name, obj in (
        ("a_g1", pk.a_g1), ("b_g2", pk.b_g2), ("h_g1", pk.h_g1), ("pk", pk), ("qap", qap),
        ("qap.coo_dev", qap.coo_dev["A"][2]), ("circuit", holder._circuit()))}
    out = {"issuer": issuer, "statuses": statuses, "cold": cold_proof, "warm": holder.proof,
           "recorder": rec}
    del holder, pk, qap
    out["alive_when_dropped"] = {name: r() is not None for name, r in refs.items()}
    gc.collect()
    out["alive_after_collect"] = {name: r() is not None for name, r in refs.items()}
    return out


def test_the_cold_proof_is_the_warm_holders(cold):
    assert cold["statuses"] == [ZKLAIM_OK, ZKLAIM_OK]
    assert len(cold["cold"]) == 260 and cold["cold"] == cold["warm"]
    assert len(cold["issuer"].pk) == PK_BYTES


def test_the_reference_accepts_the_cold_proof(cold):
    keys = ref.reference_keys(0, random.Random(SETUP), random.Random("rows"))
    a, b, c = ref.parse_proof(cold["cold"])
    weights = random.Random(1)
    assert ref.proofs_verify(keys["vk"], [(ref.public_inputs([]), (a, b, c))], weights) == [True]
    altered = (a, b, c + g1_generator())
    assert ref.proofs_verify(keys["vk"], [([], altered)], weights) == [False]


def test_a_dropped_holder_keeps_nothing_alive(cold):
    """The pk tables and the QAP (what lives on the card) go as the holder
    is dropped; the circuit, a cycle with its witness program on the host,
    goes with the collector's next run."""
    assert cold["alive_after_collect"] == dict.fromkeys(cold["alive_after_collect"], False)
    on_card = {k: v for k, v in cold["alive_when_dropped"].items() if k != "circuit"}
    assert on_card == dict.fromkeys(on_card, False)


def test_the_cold_proofs_spans_and_the_imports_counters(cold):
    spans = cold["recorder"].spans
    assert all(end is not None for _, end, _, _ in spans)

    def at(name, parent=None):
        return [i for i, (_, _, n, p) in enumerate(spans)
                if n == name and (parent is None or p == parent)]

    def children(i):
        return [n for _, _, n, p in spans if p == i]

    first, warm = at("claims.proof_generate")
    assert children(first) == ["claims.circuit", "claims.pk_import", "claims.witness",
                               "groth16.prove", "claims.proof_bytes"]
    assert children(at("claims.pk_import", first)[0]) == [
        "serde.pk_decode", "serde.pk_check", "groth16.qap"]
    assert children(at("claims.witness", first)[0]) == ["claims.witness_program"]
    assert children(warm) == ["claims.witness", "groth16.prove", "claims.proof_bytes"]
    assert children(at("claims.witness", warm)[0]) == []
    assert len(at("serde.pk_decode")) == len(at("groth16.qap")) == 1
    counts = {}
    for _, name, n in cold["recorder"].counts:
        counts.setdefault(name, []).append(n)
    assert counts["serde.pk_points"] == [PK_POINTS] and counts["serde.pk_bytes"] == [PK_BYTES]
    assert counts["claims.in_flight"] == [1, 1]
