"""Port Groth16 (zklaim_tpu_torch.groth16) against the JAX package.

On the small credential-shaped circuit: the JAX setup and prove run ONCE
(module fixture; both are XLA-compile-bound on CPU) with seeded rngs.
Then
  - the JAX proving key carried across (convert.pk_from_arrays) and the
    same prover seed give the same proof points from the port's prove;
  - the port's own setup with the setup seed gives the same pk tables
    (projective, limb for limb) and vk points;
  - the port's H coefficients equal the JAX h-pipeline's;
  - an unsatisfied witness raises ValueError before any MSM;
  - end to end: from one seed the two packages give identical
    proof, vk and pk bytes (each package's claims.serde on its own result).
The two packages have their own host classes, so points are carried
across by groth16.convert or compared as bytes.
"""

import random

import numpy as np
import pytest

import torch

import __graft_entry__ as GE
from zklaim_tpu.claims import serde as JS
from zklaim_tpu.groth16 import api as JA

from zklaim_tpu_torch import entry
from zklaim_tpu_torch.claims import serde as TS
from zklaim_tpu_torch.ff.limbs import to_tensor
from zklaim_tpu_torch.groth16 import api as TA
from zklaim_tpu_torch.groth16 import convert
from zklaim_tpu_torch.groth16.qap import QAP

# The suite runs as several worker processes on a few cores; torch's
# intra-op threads would only contend with them.
torch.set_num_threads(1)

SETUP_SEED, PROVE_SEED = 20261016, 7
TABLES = ("a_g1", "b_g1", "b_g2", "h_g1", "l_g1")


@pytest.fixture(scope="module")
def ref():
    cs, witness = GE._tiny_circuit()
    pk, vk, qap = JA.setup(cs, random.Random(SETUP_SEED))
    proof = JA.prove(pk, qap, witness, random.Random(PROVE_SEED))
    w_pad = np.zeros((qap.num_vars_pad, 16), dtype=np.uint32)
    w_pad[: qap.num_vars] = JA.witness_plain_limbs(witness)
    h_plain, n_bad = JA.h_pipeline(qap)(w_pad)
    return {"pk": pk, "vk": vk, "qap": qap, "proof": proof,
            "h": np.asarray(h_plain), "n_bad": int(n_bad)}


@pytest.fixture(scope="module")
def port():
    cs, witness = entry.tiny_circuit()
    return cs, witness, QAP.for_cs(cs, "cpu")


@pytest.fixture(scope="module")
def port_setup():
    cs, _ = entry.tiny_circuit()
    return TA.setup(cs, random.Random(SETUP_SEED), "cpu")


def test_prove_on_carried_pk_matches_jax(ref, port):
    cs, witness, qap = port
    pk = convert.pk_from_arrays(ref["pk"], "cpu")
    proof = TA.prove(pk, qap, witness, random.Random(PROVE_SEED))
    assert proof == convert.proof_from_host(ref["proof"])
    assert TS.proof_to_bytes(proof) == JS.proof_to_bytes(ref["proof"])
    vk = convert.vk_from_host(ref["vk"])
    primary = list(witness[1 : cs.num_primary + 1])
    assert TA.verify(vk, primary, proof)
    assert not TA.verify(vk, [primary[0] + 1] + primary[1:], proof)


def test_setup_matches_jax(ref, port_setup):
    pk, vk, qap = port_setup
    jpk, jvk = ref["pk"], ref["vk"]
    for name in TABLES:
        want = convert.pack_rows(getattr(jpk, name))
        np.testing.assert_array_equal(getattr(pk, name).numpy(), want, err_msg=name)
    for name in ("num_vars", "num_primary", "m"):
        assert getattr(pk, name) == getattr(jpk, name), name
    for name in ("alpha_g1", "beta_g1", "delta_g1", "beta_g2", "delta_g2"):
        deg = 2 if name.endswith("g2") else 1
        assert getattr(pk, name) == convert.host_point(deg, getattr(jpk, name)), name
    want = convert.vk_from_host(jvk)
    for name in ("alpha_g1", "beta_g2", "gamma_g2", "delta_g2", "ic"):
        assert getattr(vk, name) == getattr(want, name), name


def test_one_seed_gives_identical_bytes(ref, port, port_setup):
    """End to end: the port's setup and prove from the seeds of
    the JAX fixture, each package's own serde on its own result -- proof,
    vk and pk bytes are identical."""
    _, witness, _ = port
    pk, vk, qap = port_setup
    proof = TA.prove(pk, qap, witness, random.Random(PROVE_SEED))
    assert TS.proof_to_bytes(proof) == JS.proof_to_bytes(ref["proof"])
    assert TS.vk_to_bytes(vk) == JS.vk_to_bytes(ref["vk"])
    assert TS.pk_to_bytes(pk, 0) == JS.pk_to_bytes(ref["pk"], 0)


def test_h_coefficients_match_jax(ref, port):
    _, witness, qap = port
    assert ref["n_bad"] == 0
    w_plain = to_tensor(TA.witness_plain_limbs(witness), "cpu")
    np.testing.assert_array_equal(TA.h_plain(qap, w_plain, witness).numpy(),
                                  ref["h"].astype(np.int32))


def test_qap_matches_jax(ref, port):
    _, _, qap = port
    jq = ref["qap"]
    assert (qap.m, qap.num_vars, qap.num_primary, qap.n_cons) == (
        jq.m, jq.num_vars, jq.num_primary, jq.n_cons)
    carried = convert.qap_from_coo(jq.coo_host, jq.num_vars, jq.num_primary, jq.n_cons, "cpu")
    for name in "ABC":
        nnz = len(jq.coo_host[name][0])
        for got, via, want in zip(qap.coo_dev[name], carried.coo_dev[name], jq.coo_dev[name]):
            assert torch.equal(got, via)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:nnz].astype(got.numpy().dtype))


def test_unsatisfied_witness_raises(port):
    cs, _, qap = port
    _, build = entry._tiny_system()
    bad = build([100, 101, 102, 103], [200, 11, 12, 13])      # attr 0 > bound 0
    pk = TA.ProvingKey(qap.num_vars, qap.num_primary, qap.m, *([None] * 10))
    with pytest.raises(ValueError, match="unsatisfied constraint"):
        TA.prove(pk, qap, bad, random.Random(1))
