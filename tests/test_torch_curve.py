"""Port curve layer (zklaim_tpu_torch.ec) against jaxcurve and hostcurve.

The plain point_add (K4's plain version) follows jaxcurve.point_add's
dataflow, so projective outputs must match limb for limb.  Batch of 8
lanes: random points, P + P, P + (-P), infinity on either side.  Host
points are the port's own CurvePoints; jaxcurve reads them by attribute.
"""

import random

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from zklaim_tpu.ec import jaxcurve as JC
from zklaim_tpu_torch.ec import curve as C
from zklaim_tpu_torch.ec import gpu_curve as G
from zklaim_tpu_torch.ec.hostcurve import g1_generator, g2_generator
from zklaim_tpu_torch.ff.params import R

# The suite runs as several worker processes on a few cores; torch's
# intra-op threads would only contend with them.
torch.set_num_threads(1)

GROUPS = [(1, JC.FQ_OPS, C.FQ_OPS, g1_generator), (2, JC.FQ2_OPS, C.FQ2_OPS, g2_generator)]


def _host_pairs(gen, seed):
    rnd = random.Random(seed)
    g = gen()
    pts = [g * rnd.randrange(1, R) for _ in range(5)]
    inf = g.infinity(g.b)
    p = [pts[0], pts[1], pts[2], pts[3], inf, pts[4], inf, pts[0]]
    q = [pts[4], pts[1], -pts[2], inf, pts[3], pts[3], inf, pts[1] + pts[2]]
    return p, q


def _jax(pt):
    return tuple(jnp.asarray(c.numpy().astype(np.uint32)) for c in pt)


@pytest.mark.parametrize("deg,jf,tf,gen", GROUPS, ids=["G1", "G2"])
def test_point_add_matches_jaxcurve(deg, jf, tf, gen):
    hp, hq = _host_pairs(gen, 30 + deg)
    p, q = C.host_points_to_proj(tf, hp, "cpu"), C.host_points_to_proj(tf, hq, "cpu")
    # make the inputs genuinely projective: run them through one add with
    # infinity first (Z != 1 afterwards)
    inf = C.point_infinity(tf, (8,), "cpu")
    p, q = C.point_add(tf, p, inf), C.point_add(tf, inf, q)
    got = C.point_add(tf, p, q)
    want = JC.point_add(jf, _jax(p), _jax(q))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int32))
    assert C.proj_to_host_points(tf, got) == [a + b for a, b in zip(hp, hq)]


@pytest.mark.parametrize("deg,jf,tf,gen", GROUPS, ids=["G1", "G2"])
def test_plane_wrappers_on_cpu(deg, jf, tf, gen):
    """point_add_planes / point_add_halves on CPU tensors run the plain
    version; halves mode adds lanes i and i + w/2."""
    hp, hq = _host_pairs(gen, 40 + deg)
    p = C.point_to_planes(tf, C.host_points_to_proj(tf, hp, "cpu"))
    q = C.point_to_planes(tf, C.host_points_to_proj(tf, hq, "cpu"))
    s = G.point_add_planes(deg, p, q)
    want = JC.point_add(jf, _jax(C.planes_to_point(tf, p)), _jax(C.planes_to_point(tf, q)))
    for g, w in zip(C.planes_to_point(tf, s), want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int32))
    both = torch.cat([p, q], dim=2)
    assert torch.equal(G.point_add_halves(deg, both), s)
    assert torch.equal(G.point_add_plain(deg, p, q), s)


@pytest.mark.parametrize("deg,jf,tf,gen", GROUPS, ids=["G1", "G2"])
def test_host_conversions_roundtrip(deg, jf, tf, gen):
    hp, _ = _host_pairs(gen, 50 + deg)
    proj = C.host_points_to_proj(tf, hp, "cpu")
    for g, w in zip(proj, JC.host_points_to_proj(jf, hp)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int32))
    assert C.proj_to_host_points(tf, proj) == hp
    planes = C.point_to_planes(tf, proj)
    assert planes.shape == (3 * deg, 16, len(hp))
    rows = C.planes_to_rows(planes)
    assert rows.shape == (len(hp), 48 * deg)
    assert torch.equal(C.rows_to_planes(rows), planes)
    assert C.planes_to_host_points(deg, planes) == hp
    neg = C.point_neg(tf, proj)
    assert C.proj_to_host_points(tf, neg) == [-x for x in hp]
    mask = torch.tensor([True, False] * 4)
    sel = C.point_select(tf, mask, proj, neg)
    assert C.proj_to_host_points(tf, sel) == [x if i % 2 == 0 else -x for i, x in enumerate(hp)]
