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


def test_msm_many_padding_and_chunks_match_host():
    """Three sums of 20, 9 and 5 points: k pads to 4 with an empty sum,
    every point axis to 24 = 3 chunks of 8, whose window partials are
    summed before one finish that runs the sums side by side."""
    cases = [_case(g1_generator, n, 70 + n) for n in (20, 9, 5)]
    pairs = [(_rows(1, pts), _scalars(sc)) for pts, sc in cases]
    got = TP.msm_many(1, pairs, 4, chunk=8)
    assert got.shape == (3, 16, 3)
    assert C.planes_to_host_points(1, got) == [_host_sum(pts, sc) for pts, sc in cases]


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
