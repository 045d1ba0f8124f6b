"""The port's complete doubling (kernel K5's plain version) against
jaxcurve.point_double, and the MSM finish that now doubles with it.

curve.point_double and gpu_curve.point_double_plain follow the dataflow
of jaxcurve.point_double (which zklaim_tpu/ec/pallas_curve.py documents
its Pallas doubling kernel as bit-identical to), so projective outputs
must match limb for limb: G1 and G2, 8 lanes, infinity included.  Integer
arithmetic: tolerance 0.  The Pallas kernel itself is not run here: in
interpret mode on a CPU its 8-lane doubling took 34 s for G1 and 175 s for
G2 (and agreed), which is why the JAX package marks its own test of it
slow.
"""

import random

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from zklaim_tpu.ec import jaxcurve as JC
from zklaim_tpu.msm import pippenger as JP

from zklaim_tpu_torch.ec import curve as C
from zklaim_tpu_torch.ec import gpu_curve as G
from zklaim_tpu_torch.ec.hostcurve import g1_generator, g2_generator
from zklaim_tpu_torch.ff.limbs import ints_to_limbs
from zklaim_tpu_torch.ff.params import R
from zklaim_tpu_torch.msm import gpu_msm as GM
from zklaim_tpu_torch.msm import pippenger as TP

# The suite runs as several worker processes on a few cores; torch's
# intra-op threads would only contend with them.
torch.set_num_threads(1)

GROUPS = [(1, JC.FQ_OPS, C.FQ_OPS, g1_generator), (2, JC.FQ2_OPS, C.FQ2_OPS, g2_generator)]


def _points(tf, gen, seed, n=8):
    """n projective lanes with Z != 1 (one add with infinity first), lanes
    2 and 5 infinity."""
    rnd = random.Random(seed)
    g = gen()
    host = [g * rnd.randrange(1, R) for _ in range(n)]
    host[2] = host[5] = g.infinity(g.b)
    p = C.host_points_to_proj(tf, host, "cpu")
    return host, C.point_add(tf, p, C.point_infinity(tf, (n,), "cpu"))


def _jax(pt):
    return tuple(jnp.asarray(c.numpy().astype(np.uint32)) for c in pt)


def _same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int32))


@pytest.mark.parametrize("deg,jf,tf,gen", GROUPS, ids=["G1", "G2"])
def test_point_double_matches_jaxcurve(deg, jf, tf, gen):
    host, p = _points(tf, gen, 90 + deg)
    got = C.point_double(tf, p)
    _same(got, JC.point_double(jf, _jax(p)))
    # twice in a row: the second input is a genuine doubling output
    _same(C.point_double(tf, got), JC.point_double(jf, JC.point_double(jf, _jax(p))))
    assert C.proj_to_host_points(tf, got) == [x + x for x in host]


@pytest.mark.parametrize("deg,jf,tf,gen", GROUPS, ids=["G1", "G2"])
def test_double_planes_on_cpu(deg, jf, tf, gen):
    """point_double_planes on CPU tensors runs point_double_plain; both
    equal jaxcurve.point_double, and 2P equals P + P in affine form (the
    add and the doubling are different complete formulas, so their
    projective coordinates differ by a scale)."""
    host, p = _points(tf, gen, 95 + deg)
    planes = C.point_to_planes(tf, p)
    got = G.point_double_planes(deg, planes)
    assert torch.equal(got, G.point_double_plain(deg, planes))
    _same(C.planes_to_point(tf, got), JC.point_double(jf, _jax(p)))
    added = G.point_add_planes(deg, planes, planes)
    assert C.planes_to_host_points(deg, got) == C.planes_to_host_points(deg, added)
    assert C.planes_to_host_points(deg, got) == [x + x for x in host]


def test_msm_finish_matches_jax_projectively():
    """The port's finish on its own window partials equals the JAX
    package's _finish on the same partials limb for limb: both double with
    point_double and add with point_add in the same order.  (The whole
    msm_pow2 is compared with the JAX package in affine form, in
    test_torch_msm: at these sizes the JAX msm runs its ladder, another
    dataflow, and its flat pipeline takes minutes of XLA compile on a CPU.)"""
    rnd = random.Random(99)
    g = g1_generator()
    pts = [g * rnd.randrange(1, R) for _ in range(8)]
    pts[3] = g.infinity(g.b)
    sc = [rnd.randrange(R) for _ in range(8)]
    f = C.FQ_OPS
    rows = C.planes_to_rows(C.point_to_planes(f, C.host_points_to_proj(f, pts, "cpu")))
    scalars = torch.from_numpy(ints_to_limbs(sc).astype(np.int32))
    tot, head = TP._window_partials(1, [(rows, scalars)], 8)
    got = GM.finish(1, tot, head, 8, 1)

    def planes(t):                      # (3, 16, W) -> three (16, W) u32 planes
        return tuple(jnp.asarray(c.numpy().astype(np.uint32)) for c in t)

    want = JP._finish(JC.FQ_OPS, planes(tot), planes(head), 8)
    for g_, w in zip(C.planes_to_point(f, got), want):
        np.testing.assert_array_equal(g_.numpy()[0], np.asarray(w).astype(np.int32))
    acc = pts[0] * sc[0]
    for p_, s in zip(pts[1:], sc[1:]):
        acc = acc + p_ * s
    assert C.planes_to_host_points(1, got)[0] == acc
    assert torch.equal(TP.msm_pow2(1, rows, scalars, 8), got)
