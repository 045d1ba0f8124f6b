"""The port's credential layer (zklaim_tpu_torch.claims.api, .store)
against the JAX package's: the cases of tests/test_claims_api.py on the
port, payload and context wire bytes equal to the JAX package's for the
same fields, the zero-payload context (full real setup, cheapest circuit)
through the three roles on the CPU with every failure status, and the
store round trip.  No XLA compile runs here: the JAX classes are used for
their host-side wire formats only.
"""

import hashlib
import random

import pytest

import torch

from zklaim_tpu.claims import api as JAPI

from zklaim_tpu_torch import entry
from zklaim_tpu_torch.claims import serde, signing, store
from zklaim_tpu_torch.claims.api import (
    HEADER_WIRE_SIZE,
    PAYLOAD_WIRE_SIZE,
    ZKLAIM_ERROR,
    ZKLAIM_INVALID_PROOF,
    ZKLAIM_INVALID_SIGNATURE,
    ZKLAIM_OK,
    Context,
    Payload,
    ZkOp,
)
from zklaim_tpu_torch.groth16.api import ProvingKey
from zklaim_tpu_torch.groth16.qap import QAP
from zklaim_tpu_torch.utils.profiling import recording

# The suite runs as several worker processes on a few cores; torch's
# intra-op threads would only contend with them.
torch.set_num_threads(1)


@pytest.fixture
def rng():
    return random.Random(0xC0FFEE)


def issuer_payload(rng=None, cls=Payload, op=ZkOp):
    pl = cls()
    pl.set_attr(25, 0)           # age
    pl.set_attr(40000, 1)        # salary
    pl.data_ref = [18, 50000, 0, 0, 0]
    pl.data_op = [op.GREATER_OR_EQ, op.LESS, op.NOOP, op.NOOP, op.NOOP]
    pl.hash_payload(rng)
    return pl


def test_set_attr_and_hash(rng):
    pl = issuer_payload(rng)
    assert pl.pre[:8] == (25).to_bytes(8, "little")
    assert pl.pre[8:16] == (40000).to_bytes(8, "little")
    assert pl.pre[40:48] == pl.salt.to_bytes(8, "little")
    assert pl.hash == hashlib.sha256(pl.pre).digest()
    # reference quirk: pos == 5 overwrites the salt slot; pos == 6 errors
    assert pl.set_attr(1, 5) == ZKLAIM_OK
    assert pl.set_attr(1, 6) == ZKLAIM_ERROR


def test_payload_wire_roundtrip(rng):
    pl = issuer_payload(rng)
    raw = pl.to_bytes()
    assert len(raw) == PAYLOAD_WIRE_SIZE
    assert raw[64:72] == pl.salt.to_bytes(8, "little")
    assert raw[72:104] == pl.hash
    assert raw[40:44] == int(ZkOp.GREATER_OR_EQ).to_bytes(4, "little")
    assert raw[60:64] == bytes(4)  # alignment padding
    back = Payload.from_bytes(raw)
    assert back.to_bytes() == raw
    assert back.data_ref == pl.data_ref and back.pre == pl.pre


def test_blinding(rng):
    pl = issuer_payload(rng)
    pl.clear_pre()
    assert pl.pre == bytes(48) and pl.salt == 0 and pl.priv == 1
    assert pl.hash != bytes(32)  # hash stays


def test_context_serialize_roundtrip(rng):
    ctx = Context("cpu")
    ctx.add_payload(issuer_payload(rng))
    ctx.add_payload(issuer_payload(rng))
    ctx.vk = b"FAKE-VK-BYTES"
    ctx.proof = b"FAKE-PROOF"
    priv = signing.keygen(rng)
    assert ctx.sign(priv, rng) == ZKLAIM_OK

    raw = ctx.serialize()
    assert len(raw) == HEADER_WIRE_SIZE + 2 * PAYLOAD_WIRE_SIZE + len(ctx.vk) + 64 + len(ctx.proof)
    back, status = Context.deserialize(raw, "cpu")
    assert status == ZKLAIM_OK
    assert back.device == "cpu"
    assert back.num_payloads == 2
    assert back.vk == ctx.vk and back.proof == ctx.proof
    assert back.pub_key == ctx.pub_key and back.signature == ctx.signature
    assert back.payloads[0].to_bytes() == ctx.payloads[0].to_bytes()
    assert back.verify_signature()


def test_deserialize_rejects_corruption(rng):
    ctx = Context("cpu")
    ctx.add_payload(issuer_payload(rng))
    priv = signing.keygen(rng)
    ctx.sign(priv, rng)
    raw = bytearray(ctx.serialize())

    _, status = Context.deserialize(bytes(raw[:-1]), "cpu")      # truncated
    assert status == ZKLAIM_ERROR
    bad = bytearray(raw)
    bad[0] ^= 1                                           # header digest broken
    _, status = Context.deserialize(bytes(bad), "cpu")
    assert status == ZKLAIM_ERROR
    bad = bytearray(raw)
    bad[50] ^= 1                                          # the digest itself, at offset 48
    _, status = Context.deserialize(bytes(bad), "cpu")
    assert status == ZKLAIM_ERROR


def test_signature_detects_tampered_refs(rng):
    """Prover edits refs + rehashes -> the signed view changes -> sig fails."""
    ctx = Context("cpu")
    ctx.add_payload(issuer_payload(rng))
    ctx.vk = b"vk"
    priv = signing.keygen(rng)
    ctx.sign(priv, rng)
    assert ctx.verify_signature()

    ctx.payloads[0].data_ref[0] = 10   # claim "age >= 10" instead
    ctx.payloads[0].hash_payload(rng)  # rehash changes the signed view
    assert not ctx.verify_signature()
    assert ctx.verify() == ZKLAIM_INVALID_SIGNATURE


def test_verify_reports_missing_proof(rng):
    """No proof present -> ZKLAIM_INVALID_PROOF."""
    ctx = Context("cpu")
    ctx.add_payload(issuer_payload(rng))
    ctx.vk = b"vk"
    priv = signing.keygen(rng)
    ctx.sign(priv, rng)
    assert ctx.verify() == ZKLAIM_INVALID_PROOF


def test_wire_bytes_equal_jax_package():
    """The same fields and the same rng give the same payload, signature
    and context bytes in both packages; each reads the other's context."""
    ours, theirs = Context("cpu"), JAPI.Context()
    r1, r2 = random.Random(5), random.Random(5)
    for ctx, r, cls, op in ((ours, r1, Payload, ZkOp), (theirs, r2, JAPI.Payload, JAPI.ZkOp)):
        ctx.add_payload(issuer_payload(r, cls, op))
        ctx.add_payload(issuer_payload(r, cls, op))
        ctx.vk, ctx.proof = b"SOME-VK", b"SOME-PROOF"
    assert [int(o) for o in ZkOp] == [int(o) for o in JAPI.ZkOp]
    assert ours.payloads[1].to_bytes() == theirs.payloads[1].to_bytes()
    assert ours.payloads[0].op_positions() == theirs.payloads[0].op_positions()
    priv = signing.keygen(r1)
    assert priv == JAPI.signing.keygen(r2)
    assert ours.sign(priv, r1) == theirs.sign(priv, r2) == ZKLAIM_OK
    assert ours.signature == theirs.signature and ours.pub_key == theirs.pub_key
    raw = ours.serialize()
    assert raw == theirs.serialize()
    back, status = JAPI.Context.deserialize(raw)
    assert status == JAPI.ZKLAIM_OK and back.verify_signature()
    back, status = Context.deserialize(theirs.serialize(), "cpu")
    assert status == ZKLAIM_OK and back.verify_signature()
    assert (ZKLAIM_OK, ZKLAIM_ERROR, ZKLAIM_INVALID_SIGNATURE, ZKLAIM_INVALID_PROOF) == (
        JAPI.ZKLAIM_OK, JAPI.ZKLAIM_ERROR, JAPI.ZKLAIM_INVALID_SIGNATURE,
        JAPI.ZKLAIM_INVALID_PROOF)


@pytest.fixture(scope="module")
def flow():
    """The zero-payload credential flow on the CPU: issuer -> one holder
    (a fresh context that imports the pk from bytes) -> verifier, then the
    failures that need no payload; the program's spans and counters
    recorded meanwhile (under "recorder")."""
    with recording() as rec:
        out = entry.run_credential_path("cpu", num_payloads=0, requests=1, seed=7)
    return {**out, "recorder": rec}


def test_zero_payload_flow_statuses(flow):
    st = flow["status"]
    assert flow["statuses_ok"], (st, flow["expected"])
    assert st["trusted_setup"] == ZKLAIM_OK and st["sign"] == [ZKLAIM_OK]
    assert st["pre_proof_verify"] == [ZKLAIM_INVALID_PROOF]
    assert st["proof_generate"] == [ZKLAIM_OK] and st["reprove"] == ZKLAIM_OK
    assert st["verify"] == [ZKLAIM_OK]
    assert st["flipped_proof_byte"] == ZKLAIM_INVALID_PROOF
    assert st["off_curve_pk"] == ZKLAIM_ERROR
    assert st["payload_count_mismatch"] == ZKLAIM_ERROR
    assert (flow["vk_bytes"], flow["proof_bytes"]) == (8 + 64 + 3 * 128 + 64, 260)
    assert flow["pk_bytes"] == 20 + 3 * 64 + 2 * 128 + 64 * 2 + 128
    assert (flow["num_vars"], flow["num_primary"], flow["m"]) == (1, 0, 1)
    assert flow["device"] == "cpu"
    assert all(v == 0 for v in flow["reprove_launches"].values())   # plain versions on the CPU


def test_the_span_tree_of_a_proof_generate(flow):
    """The spans of the flow: the issuer's setup, the holder's first proof
    (a fresh context: circuit, pk import, witness, the prover's stages, the
    proof's bytes), the reprove on the cached key, the verifier's three;
    every span closed, the sums' lanes counted once a proof (N = 0:
    G1 4 sums of 2 points, 6 of them infinity; G2 1 of 2, 1), the upload's
    bytes once a proof (the witness's int64 lane of one variable, no big
    row: 8 B), each proof_generate the only one in flight (one thread), and
    no witness hook run one by one."""
    rec = flow["recorder"]
    spans = rec.spans
    assert all(end is not None for _, end, _, _ in spans)

    def at(name, parent=None):
        return [i for i, (_, _, n, p) in enumerate(spans)
                if n == name and (parent is None or p == parent)]

    def children(i):
        return [n for _, _, n, p in spans if p == i]

    assert children(at("claims.trusted_setup")[0]) == [
        "claims.circuit", "groth16.setup", "serde.pk_to_bytes"]
    first, reprove = [i for i in at("claims.proof_generate")
                      if "groth16.prove" in children(i)]
    assert children(first) == ["claims.circuit", "claims.pk_import", "claims.witness",
                               "groth16.prove", "claims.proof_bytes"]
    assert children(reprove) == ["claims.witness", "groth16.prove", "claims.proof_bytes"]
    prove = at("groth16.prove", first)[0]
    assert children(prove) == ["groth16.upload", "groth16.witness_map", "groth16.check",
                               "ntt.h", "msm.g1", "msm.g2", "groth16.finish"]
    assert children(at("ntt.h", prove)[0]) == ["ntt.transforms", "ntt.pointwise",
                                               "ntt.coset_intt"]
    for deg in (1, 2):
        g = at(f"msm.g{deg}", prove)[0]
        assert children(g) == ["msm.pass", "msm.finish"]
        assert children(at("msm.pass", g)[0]) == [
            "msm.digits", "msm.sort", "msm.gather", "msm.upsweep", "msm.tails", "msm.abel"]
    assert {"verifier.signature", "verifier.decode", "verifier.pairing"} <= {
        n for _, _, n, _ in spans}
    proofs = len(at("groth16.prove"))
    counted = {}
    for _, name, n in rec.counts:
        counted[name] = counted.get(name, 0) + n
    assert counted == {"msm.lanes": 10 * proofs, "msm.padded_lanes": 7 * proofs,
                       "groth16.upload_bytes": 8 * proofs,
                       "claims.in_flight": len(at("claims.proof_generate")),
                       "claims.witness_py_hooks": 0}


def test_cli_bench_header_matches_jax_package():
    """`cli bench` writes the reference benchmark's CSV (main_benchmark.c):
    the port's header is the JAX package's, byte for byte.  With no payload
    count to sweep, neither runs a setup."""
    import io

    from zklaim_tpu import cli as jax_cli
    from zklaim_tpu_torch import cli

    theirs, ours = io.StringIO(), io.StringIO()
    jax_cli.bench(max_payloads=0, out=theirs)
    cli.bench(max_payloads=0, out=ours, device="cpu")
    assert ours.getvalue() == theirs.getvalue()
    assert ours.getvalue().splitlines() == [
        "timestamp,num_payloads,issuer_ms,prover_ms,verifier_ms,pk_B,vk_B,proof_B"]


def test_unsatisfied_predicate_is_an_error_status():
    """proof_generate on attributes that do not satisfy the predicate
    returns ZKLAIM_ERROR (the prover's ValueError before any MSM), never an
    exception.  One payload, so the real 25,412-variable circuit: its
    setup is not run on the CPU, the context's pk cache is primed with a
    key whose tables are never reached."""
    ctx = Context("cpu")
    pl = Payload()
    pl.set_attr(17, 0)
    pl.data_ref = [18, 0, 0, 0, 0]
    pl.data_op = [ZkOp.GREATER_OR_EQ] + [ZkOp.NOOP] * 4        # 17 >= 18 is false
    ctx.add_payload(pl)
    ctx.hash_payloads(random.Random(1))
    qap = QAP.for_cs(ctx._circuit().cs, "cpu")
    pk = ProvingKey(qap.num_vars, qap.num_primary, qap.m, *([None] * 10))
    ctx.pk = b"ZKPK-primed"
    ctx._pk_cache = (ctx.pk, 1, pk, qap)
    assert ctx.proof_generate(random.Random(2)) == ZKLAIM_ERROR
    assert ctx.proof == b""
    ctx.pk = b"ZKPK-not-a-key"                   # cache miss -> parse -> SerdeError
    assert ctx.proof_generate(random.Random(2)) == ZKLAIM_ERROR


def test_context_defaults_to_the_card():
    """Context() means the card: where there is none, setup raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Context().trusted_setup(random.Random(1))


def test_deepcopy_shares_caches_and_device():
    import copy

    ctx = Context("cpu")
    ctx.add_payload(issuer_payload(random.Random(3)))
    ctx._pk_cache = ("pk", 1, object(), object())
    twin = copy.deepcopy(ctx)
    assert twin.device == "cpu" and twin._pk_cache is ctx._pk_cache
    assert twin.payloads[0] is not ctx.payloads[0]
    assert twin.payloads[0].to_bytes() == ctx.payloads[0].to_bytes()


def test_store_roundtrip(tmp_path):
    rng = random.Random(7)
    ctx = Context("cpu")
    assert ctx.trusted_setup(rng) == ZKLAIM_OK
    assert ctx.sign(signing.keygen(rng), rng) == ZKLAIM_OK
    store.save_issuer_state(str(tmp_path), ctx)
    back = store.load_issuer_state(str(tmp_path), "cpu")
    assert back.device == "cpu"
    assert back.pk == ctx.pk and back.vk == ctx.vk
    assert back.pub_key == ctx.pub_key and back.signature == ctx.signature
    assert back.verify_signature()
    p = tmp_path / "pk.zkl"
    p.write_bytes(b"NOPE" + bytes(64))
    with pytest.raises(serde.SerdeError):
        store.load_proving_key(str(p))
    raw = bytearray(ctx.serialize())
    raw[50] ^= 0xFF                              # break the header digest
    (tmp_path / "ctx.zkl").write_bytes(bytes(raw))
    with pytest.raises(ValueError):
        store.load_context(str(tmp_path / "ctx.zkl"), "cpu")
    target = tmp_path / "sub" / "x.bin"
    store._atomic_write(str(target), b"abc")
    assert target.read_bytes() == b"abc"
    assert [f.name for f in (tmp_path / "sub").iterdir()] == ["x.bin"]
