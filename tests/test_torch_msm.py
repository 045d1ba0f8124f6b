"""Port MSM (zklaim_tpu_torch.msm) against the JAX package and hostcurve.

msm_pow2 runs the flat Pippenger pipeline for every N; the JAX side's
`msm` takes its ladder path at these sizes (N <= 512).  Finished points
are compared in affine form (the two finishes double by different
complete formulas), digits exactly.  The JAX G2 MSM is not compiled here
(about a minute of XLA compile on CPU): the G2 sum is held to hostcurve,
and test_torch_groth16 holds the port's G2 MSM to the JAX prover's
through the proof's B point.
"""

import random

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from zklaim_tpu.ec import jaxcurve as JC
from zklaim_tpu.ec.hostcurve import g1_generator as jax_g1_generator
from zklaim_tpu.ff.limbs import ints_to_limbs
from zklaim_tpu.msm import pippenger as JP
from zklaim_tpu.msm.fixedbase import FixedBaseTable as JFixedBase

from zklaim_tpu_torch.ec import curve as C
from zklaim_tpu_torch.ec.hostcurve import g1_generator, g2_generator
from zklaim_tpu_torch.ff.params import R
from zklaim_tpu_torch.groth16.convert import host_point
from zklaim_tpu_torch.msm import fixedbase as TF
from zklaim_tpu_torch.msm import pippenger as TP

# The suite runs as several worker processes on a few cores; torch's
# intra-op threads would only contend with them.
torch.set_num_threads(1)


def _case(gen, n, seed):
    rnd = random.Random(seed)
    g = gen()
    pts = [g * rnd.randrange(1, R) for _ in range(n)]
    pts[1] = -pts[0]
    pts[2] = g.infinity(g.b)
    sc = [rnd.randrange(R) for _ in range(n)]
    sc[3], sc[4] = 0, R - 1
    return pts, sc


def _host_sum(pts, sc):
    acc = pts[0] * sc[0]
    for p, s in zip(pts[1:], sc[1:]):
        acc = acc + p * s
    return acc


def _rows(deg, pts):
    f = C.ops_for(deg)
    return C.planes_to_rows(C.point_to_planes(f, C.host_points_to_proj(f, pts, "cpu")))


def _scalars(sc):
    return torch.from_numpy(ints_to_limbs(sc).astype(np.int32))


def test_signed_digits_match_jax():
    rnd = random.Random(1)
    sc = ints_to_limbs([0, 1, R - 1] + [rnd.randrange(R) for _ in range(29)])
    for c in (4, 8):
        want = JP.signed_digits(jnp.asarray(sc), c)
        got = TP.signed_digits(torch.from_numpy(sc.astype(np.int32)), c)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("c", [4, 8])
def test_g1_msm_matches_jax_and_host(c):
    pts, sc = _case(g1_generator, 8, 61)
    want = _host_sum(pts, sc)
    f = JC.FQ_OPS
    jout = JP.msm(f, JC.host_points_to_proj(f, pts), jnp.asarray(ints_to_limbs(sc)), c)
    assert host_point(1, JC.proj_to_host_points(f, jax.tree.map(lambda a: a[None], jout))[0]) == want
    got = TP.msm_pow2(1, _rows(1, pts), _scalars(sc), c)
    assert got.shape == (3, 16, 1)
    assert C.planes_to_host_points(1, got)[0] == want


def test_g2_msm_matches_host():
    pts, sc = _case(g2_generator, 8, 62)
    got = TP.msm_pow2(2, _rows(2, pts), _scalars(sc), 8)
    assert got.shape == (6, 16, 1)
    assert C.planes_to_host_points(2, got)[0] == _host_sum(pts, sc)


@pytest.mark.parametrize("lengths, seeds, chunk", [((20, 9, 5), (90, 79, 75), 8),
                                                    ((16, 16, 31, 15), (90, 91, 92, 93), 4)])
def test_msm_many_padding_and_chunks_match_host(lengths, seeds, chunk):
    """Sums of unequal lengths: k pads to a power of two (three sums of 20,
    9 and 5 points: 4, with an empty sum), every point axis to whole
    chunks (24 = 3 chunks of 8), whose window partials are summed before
    one finish that runs the sums side by side.  The second case is the
    prover's four G1 sums at N = 20 in miniature: A, B1 and L about half as
    long as H (508,203 points against 2^20 - 1), so three of the four point
    axes are half infinity padding, in 8 chunks (64 at N = 20).  The call
    counts its lanes (4 sums of 24 and of 32 points) and the infinity rows
    among them."""
    from zklaim_tpu_torch.utils.profiling import recording

    cases = [_case(g1_generator, n, seed) for n, seed in zip(lengths, seeds)]
    pairs = [(_rows(1, pts), _scalars(sc)) for pts, sc in cases]
    with recording() as rec:
        got = TP.msm_many(1, pairs, 4, chunk=chunk)
    assert got.shape == (3, 16, len(lengths))
    assert C.planes_to_host_points(1, got) == [_host_sum(pts, sc) for pts, sc in cases]
    lanes = {(20, 9, 5): 4 * 24, (16, 16, 31, 15): 4 * 32}[lengths]
    assert [(name, n) for _, name, n in rec.counts] == [
        ("msm.lanes", lanes), ("msm.padded_lanes", lanes - sum(lengths))]


@pytest.mark.parametrize("num_payloads, lanes, padded", [(1, 163_840, 29_432),
                                                         (20, 4_718_592, 1_637_308)])
def test_msm_padding_of_the_benchmark_cells(num_payloads, lanes, padded):
    """msm.padded_lanes over msm.lanes in a proof of the benchmark's two
    circuits, from the key's dimensions (PERF.md, section 4) and the sums
    of groth16.api.prove_sums: A, B1, H and L in one G1 call, B2 alone.
    N = 20: A and B1 padded by 540,373 each, H by 1, L by 540,476, and the
    G2 sum's 508,203 points to 524,288 (34.70 %); N = 1: 17.96 %."""
    num_vars, num_primary, m = {1: (25_412, 6, 1 << 15), 20: (508_203, 102, 1 << 20)}[
        num_payloads]
    sums = {1: [num_vars, num_vars, m - 1, num_vars - num_primary - 1], 2: [num_vars]}
    total = infinity = 0
    for deg, lengths in sums.items():
        k2, n2, _ = TP.padded_shape(deg, lengths)
        total, infinity = total + k2 * n2, infinity + k2 * n2 - sum(lengths)
    assert (total, infinity) == (lanes, padded)
    assert round(100 * padded / lanes, 2) == {1: 17.96, 20: 34.70}[num_payloads]


@pytest.mark.parametrize("max_lanes", [{1: 1 << 9, 2: 1 << 8}, {1: 1 << 14, 2: 1 << 13}])
def test_chip_smoke_launch_rule_matches_prove_sums(monkeypatch, max_lanes):
    """chip_smoke._proof_launches derives a proof's msm_upsweep, msm_tails,
    msm_abel, msm_finish and point_add launches from the key's dimensions;
    the prover's sums (groth16.api.prove_sums) make that many calls of the
    launching functions (an upsweep and an Abel tree as many launches as
    their plans have).  The functions are stubbed with shape-only
    stand-ins, so only the pipeline's control flow runs: with small
    MAX_LANES both sums run in chunks (G1 16 passes, G2 5), with large ones
    in one pass each.  No pass adds through
    point_add_halves: only the chunk sums launch point_add."""
    import chip_smoke
    from zklaim_tpu_torch.groth16.api import ProvingKey, prove_sums

    calls = {"msm_upsweep": 0, "msm_tails": 0, "msm_abel": 0, "msm_finish": 0, "point_add": 0}

    def count(name, fn):
        def stub(*args):
            calls[name] += 1
            return fn(*args)
        return stub

    def upsweep(deg, level0):
        nb = level0.shape[-1].bit_length() - 1
        calls["msm_upsweep"] += len(TP.upsweep_plan(deg, nb))
        return [level0[..., : level0.shape[-1] >> t] for t in range(nb + 1)]

    def abel(deg, heads, kw):
        calls["msm_abel"] += len(TP.abel_plan(deg, heads.shape[-1], kw))
        return heads[..., :kw]

    monkeypatch.setattr(TP, "point_add_halves",
                        count("point_add", lambda deg, p: p[..., : p.shape[-1] // 2]))
    monkeypatch.setattr(TP, "point_add_planes", count("point_add", lambda deg, a, b: a))
    monkeypatch.setattr(TP, "_upsweep", upsweep)
    monkeypatch.setattr(TP, "_abel", abel)
    monkeypatch.setattr(TP, "_tails", count(
        "msm_tails", lambda deg, levels, m, nb: C.infinity_planes(deg, m.shape[0], "cpu")))
    monkeypatch.setattr(TP, "_finish", count(
        "msm_finish", lambda deg, tot, head, c, k: C.infinity_planes(deg, k, "cpu")))
    for deg, lanes in max_lanes.items():
        monkeypatch.setitem(TP.MAX_LANES, deg, lanes)
    num_vars, num_primary, m = 40, 3, 64
    rows = lambda n, deg: torch.zeros((n, 48 * deg), dtype=torch.int32)
    pk = ProvingKey(num_vars, num_primary, m, *([None] * 5), rows(num_vars, 1),
                    rows(num_vars, 1), rows(num_vars, 2), rows(m - 1, 1),
                    rows(num_vars - num_primary - 1, 1))
    w = _scalars([random.Random(5).randrange(R) for _ in range(num_vars)])
    prove_sums(pk, w, _scalars([1] * (m - 1)))
    want = chip_smoke._proof_launches(num_vars, num_primary, m)
    assert calls == {k: want[k] for k in calls}
    assert want["msm_tails"] == want["msm_abel"] == (21 if max_lanes[1] == 1 << 9 else 2)
    assert want["msm_upsweep"] == (21 if max_lanes[1] == 1 << 9 else 4)
    assert want["point_add"] == (42 if max_lanes[1] == 1 << 9 else 0)


def test_fixed_base_matches_jax_projective():
    """The comb adds run in the JAX package's order: limb-identical
    projective outputs."""
    rnd = random.Random(80)
    sc = [0, 1, R - 1] + [rnd.randrange(R) for _ in range(5)]
    jt = JFixedBase(JC.FQ_OPS, jax_g1_generator(), 8)
    want = jt.mul(jnp.asarray(ints_to_limbs(sc)))
    got = TF.fixed_base_mul(1, _scalars(sc))
    for g, w in zip(C.planes_to_point(C.FQ_OPS, got), want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int32))
    assert C.planes_to_host_points(1, got) == [g1_generator() * s for s in sc]
