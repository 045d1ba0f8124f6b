"""scalar_mul, msm_ladder and msm of the port against the JAX package.

Counterparts of jaxcurve.scalar_mul (256 steps, MSB first: double, add,
select) and pippenger.msm_ladder / msm.  The oracle is the JAX package's:
  - its host golden model zklaim_tpu.ec.hostcurve (exact integer
    arithmetic) makes the points and the expected multiples and sums, G1
    and G2, with infinity, a repeated point and the scalars 0, 1 and r - 1
    among the lanes;
  - its jitted pippenger.msm (the ladder, G1, 5 points: the program its own
    test_msm.py compiles) runs on the same points and scalars.
Points cross between the packages as integers (groth16.convert.host_point)
and results are compared as affine points: tolerance 0.  jaxcurve.scalar_mul
is reached through that msm; it is not jitted a second time on its own,
which would cost a further compile of the 256-step loop.
"""

import random

import jax
import jax.numpy as jnp
import pytest
import torch

from zklaim_tpu.ec import hostcurve as JH
from zklaim_tpu.ec import jaxcurve as JC
from zklaim_tpu.ff.limbs import ints_to_limbs as j_ints_to_limbs
from zklaim_tpu.msm import pippenger as JP

from zklaim_tpu_torch.ec import curve as C
from zklaim_tpu_torch.ec.gpu_curve import scalar_mul
from zklaim_tpu_torch.ff.limbs import ints_to_limbs, to_tensor
from zklaim_tpu_torch.ff.params import R
from zklaim_tpu_torch.groth16.convert import host_point
from zklaim_tpu_torch.msm import pippenger as P

torch.set_num_threads(1)

GENS = {1: JH.g1_generator, 2: JH.g2_generator}


def _inputs(deg, n, seed):
    """n points of the JAX package's host model (lane 1 infinity, lane 4 a
    repeat of lane 3) and scalars (0, 1, r - 1 among them), and the same as
    the port's rows and limbs."""
    rnd = random.Random(seed)
    g = GENS[deg]()
    pts = [g * rnd.randrange(1, R) for _ in range(n)]
    scalars = [rnd.randrange(R) for _ in range(n)]
    if n > 1:
        pts[1] = JH.CurvePoint.infinity(g.b)
    if n > 4:
        pts[4] = pts[3]
    for i, s in zip(range(2, n), (0, 1, R - 1)):
        scalars[i] = s
    f = C.ops_for(deg)
    carried = [host_point(deg, p) for p in pts]
    rows = C.point_to_rows(C.host_points_to_proj(f, carried, "cpu"))
    return pts, scalars, rows, to_tensor(ints_to_limbs(scalars), "cpu")


def _host_sum(pts, scalars):
    acc = JH.CurvePoint.infinity(pts[0].b)
    for p, s in zip(pts, scalars):
        acc = acc + p * s
    return acc


def _carried(deg, pts):
    return [host_point(deg, p) for p in pts]


@pytest.mark.parametrize("deg", [1, 2], ids=["G1", "G2"])
def test_scalar_mul_and_ladder_match_host(deg):
    """One ladder run serves both: lane i is scalars[i] * P_i, and the fold
    of msm_ladder (5 lanes, padded to 8 with infinity) is their sum."""
    pts, scalars, rows, sc = _inputs(deg, 5, 20 + deg)
    per = scalar_mul(deg, C.rows_to_planes(rows), sc)
    assert per.shape == (3 * deg, 16, 5)
    assert C.planes_to_host_points(deg, per) == _carried(deg, [p * s for p, s in zip(pts, scalars)])
    got = P.msm_ladder(deg, rows, sc)
    assert got.shape == (3 * deg, 16, 1)
    assert C.planes_to_host_points(deg, got) == _carried(deg, [_host_sum(pts, scalars)])


def test_msm_and_ladder_match_jitted_jax_msm():
    """G1, 5 points: the port's msm and msm_ladder against the JAX
    package's jitted msm on the same points and scalars."""
    pts, scalars, rows, sc = _inputs(1, 5, 31)
    jac = JC.host_points_to_proj(JC.FQ_OPS, pts)
    out = jax.jit(JP.msm, static_argnums=(0, 3))(JC.FQ_OPS, jac, jnp.asarray(j_ints_to_limbs(scalars)), 8)
    want = JC.proj_to_host_points(JC.FQ_OPS, jax.tree.map(lambda a: a[None], out))
    assert want == [_host_sum(pts, scalars)]
    assert C.planes_to_host_points(1, P.msm(1, rows, sc, 8)) == _carried(1, want)
    assert C.planes_to_host_points(1, P.msm_ladder(1, rows, sc)) == _carried(1, want)


def test_scalar_mul_rejects_mismatched_scalars():
    _, _, rows, sc = _inputs(1, 3, 1)
    with pytest.raises(ValueError):
        scalar_mul(1, C.rows_to_planes(rows), sc[:2])


def test_msm_ladder_of_one_point():
    pts, scalars, rows, sc = _inputs(1, 1, 5)
    assert C.planes_to_host_points(1, P.msm_ladder(1, rows, sc)) == _carried(1, [pts[0] * scalars[0]])


def test_msm_dispatch_across_the_threshold(monkeypatch):
    """msm routes N <= ZKLAIM_MSM_LADDER_MAX (default 512, as in the JAX
    package) to the ladder and larger N to the flat pipeline (msm_pow2);
    both give the host sum, and on one input the two routes give the same
    point."""
    assert P._ladder_max() == JP._ladder_max() == 512
    monkeypatch.setenv("ZKLAIM_MSM_LADDER_MAX", "3")
    assert P._ladder_max() == JP._ladder_max() == 3
    ladder, flat = P.msm_ladder, P.msm_pow2
    calls = []
    monkeypatch.setattr(P, "msm_ladder", lambda *a: (calls.append("ladder"), ladder(*a))[1])
    monkeypatch.setattr(P, "msm_pow2", lambda *a: (calls.append("flat"), flat(*a))[1])

    pts, scalars, rows, sc = _inputs(1, 4, 9)
    at = P.msm(1, rows[:3], sc[:3])
    above = P.msm(1, rows, sc)
    assert calls == ["ladder", "flat"]
    assert C.planes_to_host_points(1, at) == _carried(1, [_host_sum(pts[:3], scalars[:3])])
    assert C.planes_to_host_points(1, above) == _carried(1, [_host_sum(pts, scalars)])
    assert C.planes_to_host_points(1, flat(1, rows[:3], sc[:3])) == C.planes_to_host_points(1, at)
