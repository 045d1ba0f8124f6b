"""The port's bench entry point, batched proving and device-built NTT tables.

  - bench_msm / bench_ntt on "cpu" at log2n <= 3 return the metric names and
    units of the JAX package's bench.py.  That script runs JAX set-up when
    it is imported, so the names are held against the strings in its source.
  - batched_prove on a two-constraint circuit gives, from one seed, the
    proof bytes of successive `prove` calls (which test_torch_groth16.py
    holds to the JAX package's prove), its proofs pass the JAX package's
    verifier, and an unsatisfied witness raises ValueError with the text
    read from the source of zklaim_tpu/parallel/prove.py, the failing
    constraint named by the JAX package's ConstraintSystem.
  - NTTDomain's power tables, built by doubling through mont_mul, equal the
    JAX package's host-built tables limb for limb.
Integer arithmetic throughout: tolerance 0.
"""

import json
import random
import re
from pathlib import Path

import numpy as np
import pytest

import torch

from zklaim_tpu.claims import serde as JS
from zklaim_tpu.groth16 import api as JA
from zklaim_tpu.ntt.radix2 import NTTDomain as JaxNTTDomain
from zklaim_tpu.r1cs.system import ConstraintSystem as JaxConstraintSystem

from zklaim_tpu_torch import bench
from zklaim_tpu_torch.claims import serde
from zklaim_tpu_torch.groth16.api import prove, setup, verify
from zklaim_tpu_torch.ntt.radix2 import NTTDomain
from zklaim_tpu_torch.parallel.prove import batched_prove
from zklaim_tpu_torch.r1cs.system import ConstraintSystem

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
ORIGINAL = (ROOT / "bench.py").read_text()


def _original_has(metric: str, unit: str) -> bool:
    """The metric's name (its log2n or batch as the format field it is in
    the source) and its unit stand in the JAX package's bench.py."""
    pattern = re.sub(r"\\\^\d+", "^{log2n}", re.escape(metric))
    pattern = re.sub(r"batch\d+", "batch{batch}", pattern)
    pattern = re.sub(r"^g[12]_", "{kind}_", pattern)
    pattern = pattern.replace("\\{", "{").replace("\\}", "}").replace("\\^", "^").replace("\\_", "_")
    return f'"{pattern}"' in ORIGINAL and f'"unit": "{unit}"' in ORIGINAL


def test_original_name_matcher():
    assert _original_has("g1_msm_2^16_points_per_sec", "points/s")
    assert _original_has("groth16_proofs_per_sec_batch8", "proofs/s")
    assert not _original_has("g1_msm_2^16_points_per_second", "points/s")
    assert not _original_has("g1_msm_2^16_points_per_sec", "points")


def _check_row(row, metric, unit):
    assert row["metric"] == metric and row["unit"] == unit
    assert _original_has(row["metric"], row["unit"])
    assert row["vs_baseline"] == 1.0 and row["impl"] == "torch"
    assert row["device"] == "cpu" and "peak_mem_bytes" not in row     # no device metric
    assert row["value"] > 0
    json.dumps(row)


def test_bench_msm_row_on_cpu():
    _check_row(bench.bench_msm(3, runs=1, kind="g1", device="cpu"),
               "g1_msm_2^3_points_per_sec", "points/s")


@pytest.mark.parametrize("log2n", [3, 6])
def test_bench_ntt_row_on_cpu(log2n):
    _check_row(bench.bench_ntt(log2n, runs=1, device="cpu"),
               f"ntt_fr_2^{log2n}_elems_per_sec", "elems/s")


def test_prover_and_batched_metric_names_stand_in_the_original():
    """bench_prover and bench_batched need the full circuit (the card runs
    them); their rows' names and units are read from the port's source and
    held against the original's."""
    src = (ROOT / "zklaim_tpu_torch" / "bench.py").read_text()
    named = re.findall(r'_row\(device, f?"([^"]+)",[^"]*"([^"]+)"\)', src)
    names = {m for m, _ in named}
    assert {"groth16_prover_latency_1payload", "groth16_proofs_per_sec_1payload",
            "issuer_trusted_setup_1payload", "issuer_trusted_setup_1payload_cold",
            "verifier_latency_1payload", "proof_size", "pk_size", "vk_size",
            "groth16_proofs_per_sec_batch{batch}"} <= names
    for metric, unit in named:
        metric = metric.replace("{kind}", "g1").replace("{log2n}", "16").replace("{batch}", "8")
        assert _original_has(metric, unit), (metric, unit)


def test_make_points_are_multiples_of_the_generator():
    from zklaim_tpu_torch.ec import curve as C
    from zklaim_tpu_torch.ec.hostcurve import g1_generator

    rows = bench.make_points(1, 4, "cpu")
    g = g1_generator()
    assert C.planes_to_host_points(1, C.rows_to_planes(rows)) == [g * k for k in range(1, 5)]


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for entry in (bench.bench_msm, bench.bench_ntt, bench.bench_prover, bench.bench_batched,
                  bench.bench_all, lambda: bench.main([])):
        with pytest.raises(RuntimeError, match="CUDA"):
            entry()


# -- batched proving ---------------------------------------------------------


def _small_system(cls):
    """x * y = z, z * z = out with out public, in either package's
    ConstraintSystem: (cs, witness function)."""
    cs = cls()
    out = cs.alloc_lc()
    cs.mark_primary_end()
    x, y, z = cs.alloc_lc(), cs.alloc_lc(), cs.alloc_lc()
    cs.constrain(x, y, z, "xy")
    cs.constrain(z, z, out, "zz")

    def witness(xv, yv, outv=None):
        def init(w):
            zv = xv * yv
            for lc, v in ((x, xv), (y, yv), (z, zv), (out, zv * zv if outv is None else outv)):
                w[next(iter(lc.terms))] = v
        return cs.generate_witness(init)

    return cs, witness


@pytest.fixture(scope="module")
def small():
    """The two-constraint circuit (domain m = 4 with the consistency rows)
    set up on the CPU."""
    cs, witness = _small_system(ConstraintSystem)
    pk, vk, qap = setup(cs, random.Random(11), "cpu")
    return cs, witness, pk, vk, qap


def test_batched_prove_gives_the_bytes_of_successive_proves(small, monkeypatch):
    """Two proofs of one witness: they differ by their (r, s) alone, so the
    batch equals the successive proves only if it draws in the same order.
    The five sums of a witness are a pure function of it and take most of a
    CPU prove, so both routes share one computation of them here."""
    from zklaim_tpu_torch.groth16 import api
    from zklaim_tpu_torch.parallel import prove as parallel_prove

    sums, computed = api.prove_sums, {}

    def shared_sums(pk, w_plain, h, msm_c=8):
        key = (w_plain.numpy().tobytes(), h.numpy().tobytes(), msm_c)
        if key not in computed:
            computed[key] = sums(pk, w_plain, h, msm_c)
        return computed[key]

    monkeypatch.setattr(api, "prove_sums", shared_sums)
    monkeypatch.setattr(parallel_prove, "prove_sums", shared_sums)

    cs, witness, pk, vk, qap = small
    ws = [witness(3, 5)] * 2
    rng = random.Random(99)
    one_by_one = [serde.proof_to_bytes(prove(pk, qap, w, rng)) for w in ws]
    batch = batched_prove(None, pk, qap, ws, random.Random(99))
    assert [serde.proof_to_bytes(p) for p in batch] == one_by_one
    assert one_by_one[0] != one_by_one[1] and len(computed) == 1
    assert all(verify(vk, [225], p) for p in batch)
    assert not verify(vk, [226], batch[0])
    # the JAX package's verifier, on the bytes (the formats are one)
    jvk = JS.vk_from_bytes(serde.vk_to_bytes(vk))
    for raw in one_by_one:
        assert JA.verify(jvk, [225], JS.proof_from_bytes(raw))
        assert not JA.verify(jvk, [226], JS.proof_from_bytes(raw))
    assert batched_prove(None, pk, qap, [], rng) == []


def test_batched_prove_raises_on_an_unsatisfied_witness(small, monkeypatch):
    from zklaim_tpu_torch.parallel import prove as parallel_prove

    # the good witness before the bad one needs no sums here: none is finished
    monkeypatch.setattr(parallel_prove, "prove_sums", lambda *a: None)
    cs, witness, pk, vk, qap = small
    bad = witness(3, 5, outv=226)
    # the text as the JAX package raises it, the constraint as its own
    # ConstraintSystem names it on the same circuit and values
    src = (ROOT / "zklaim_tpu" / "parallel" / "prove.py").read_text()
    (template,) = re.findall(r'raise ValueError\(\s*f"([^"]+)"\s*\)', src)
    assert template.count("{i}") == 1
    assert template.count("{qap.cs.first_unsatisfied(witnesses[i])}") == 1
    jcs, jwitness = _small_system(JaxConstraintSystem)
    where = jcs.first_unsatisfied(jwitness(3, 5, outv=226))
    assert where == (1, "zz")
    want = (template.replace("{i}", "1")
            .replace("{qap.cs.first_unsatisfied(witnesses[i])}", str(where)))
    with pytest.raises(ValueError) as err:
        batched_prove(None, pk, qap, [witness(3, 5), bad], random.Random(1))
    assert str(err.value) == want
    with pytest.raises(ValueError, match="unsatisfied constraint"):
        prove(pk, qap, bad, random.Random(1))


# -- NTT tables ----------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 64])
def test_device_built_ntt_tables_equal_host_built(n):
    """The port builds its power tables by doubling through mont_mul; the
    JAX package builds them from host ints."""
    dom, ref = NTTDomain(n, "cpu"), JaxNTTDomain(n)
    for name, stages in (("tw_flat", ref.stage_tw), ("tw_inv_flat", ref.stage_tw_inv)):
        got = getattr(dom, name)
        want = np.concatenate(stages).T if stages else np.zeros((16, 0), dtype=np.uint32)
        assert got.shape == (16, n - 1) and got.dtype == torch.int32 and got.is_contiguous(), name
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want, err_msg=name)
    for name in ("shift_pows", "shift_pows_inv", "n_inv_mont", "z_coset_inv_mont"):
        got = getattr(dom, name)
        assert got.dtype == torch.int32 and got.is_contiguous(), name
        np.testing.assert_array_equal(got.numpy().view(np.uint32), getattr(ref, name), err_msg=name)
    np.testing.assert_array_equal(dom.bitrev.numpy(), ref.bitrev)
