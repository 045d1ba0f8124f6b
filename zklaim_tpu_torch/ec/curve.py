"""Batched projective BN254 G1/G2 arithmetic in PyTorch (plain versions).

Counterpart of zklaim_tpu/ec/jaxcurve.py.  Points are tuples (X, Y, Z) of
Montgomery-domain int32 limb tensors in homogeneous projective
coordinates: G1 coordinates (..., 16) over Fq, G2 coordinates
(..., 2, 16) over Fq2.  Infinity is (0, 1, 0).  The group law is the
complete Renes-Costello-Batina add and doubling (a = 0) with the same
dataflow as jaxcurve.point_add / point_double, so projective outputs match
them limb for limb.  Batch projective <-> affine conversion (a batched
Fermat inversion of Z) serves the byte formats of claims.serde.

Independent products are stacked into one mont_mul call, as in jaxcurve:
on the CPU that keeps the number of small torch ops down.  The plane
layout of the kernels -- one (3 deg, 16, n) tensor, G2 planes ordered
(x0, x1, y0, y1, z0, z1) -- and the packed rows of the MSM tables --
(n, 48 deg), the same order -- are converted here too.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..ff import montgomery as M
from ..ff.hostfield import Fq, Fq2
from ..ff.limbs import NUM_LIMBS, to_tensor
from ..ff.montgomery import FQ
from ..ff.params import Q
from .hostcurve import B_G1, B_G2, CurvePoint


def _stack_pairs(pairs):
    shapes = [torch.broadcast_shapes(a.shape, b.shape) for a, b in pairs]
    lhs = torch.stack([a.expand(s) for (a, _), s in zip(pairs, shapes)])
    rhs = torch.stack([b.expand(s) for (_, b), s in zip(pairs, shapes)])
    return lhs, rhs


class FqOps:
    """Fq elements: (..., 16) Montgomery-domain int32 limbs.

    plain=True forces the plain Montgomery multiply on any device (the
    reference a kernel is held against); otherwise mont_mul dispatches
    (K1 on CUDA)."""

    name = "fq"
    deg = 1

    def __init__(self, plain: bool = False):
        self._mul = M.mont_mul_plain if plain else M.mont_mul

    @staticmethod
    def add(a, b):
        return M.add_mod(FQ, a, b)

    @staticmethod
    def sub(a, b):
        return M.sub_mod(FQ, a, b)

    @staticmethod
    def neg(a):
        return M.neg_mod(FQ, a)

    @staticmethod
    def dbl(a):
        return M.add_mod(FQ, a, a)

    def mul(self, a, b):
        return self._mul(FQ, a, b)

    def mul_many(self, pairs):
        """Stack independent products into one mont_mul call."""
        return list(self._mul(FQ, *_stack_pairs(pairs)).unbind(0))

    def add_many(self, pairs):
        return list(M.add_mod(FQ, *_stack_pairs(pairs)).unbind(0))

    def sub_many(self, pairs):
        return list(M.sub_mod(FQ, *_stack_pairs(pairs)).unbind(0))

    def mul_b3(self, x):
        """9x (3b for b = 3) by the chain 2(2(2x)) + x."""
        d = self.dbl(self.dbl(self.dbl(x)))
        return self.add(d, x)

    @staticmethod
    def inv(a):
        """Batched Fermat inversion; 0 -> 0."""
        return M.mont_inv(FQ, a)

    @staticmethod
    def is_zero(a):
        return (a == 0).all(-1)

    @staticmethod
    def select(mask, a, b):
        return torch.where(mask[..., None], a, b)

    @staticmethod
    def zeros(batch_shape, device):
        return torch.zeros(tuple(batch_shape) + (NUM_LIMBS,), dtype=torch.int32, device=device)

    @staticmethod
    def ones(batch_shape, device):
        return _ones(_mont_one(1, str(device)), batch_shape)


@lru_cache(maxsize=None)
def _mont_one(deg: int, device: str) -> torch.Tensor:
    """1 in Montgomery form over Fq (16 limbs) or Fq2 ((2, 16)) on the
    device, copied there once: an upload from pageable host memory makes
    the host wait for the card, so the point constants of a pass or an MSM
    are made on the card from this one."""
    one = np.zeros((deg, NUM_LIMBS), dtype=np.int32)
    one[0] = FQ.one_mont
    return to_tensor(one if deg == 2 else one[0], device)


def _ones(one: torch.Tensor, batch_shape) -> torch.Tensor:
    """A new contiguous batch of `one` (never a view of the cached tensor)."""
    return one.expand(tuple(batch_shape) + one.shape).clone(memory_format=torch.contiguous_format)


def _b3_g2_mont() -> np.ndarray:
    """3 * b' for the G2 curve (b' = 3/xi), as (2, 16) Montgomery limbs."""
    b3 = B_G2 * 3
    return np.stack([M.encode_ints(FQ, [b3.c0])[0], M.encode_ints(FQ, [b3.c1])[0]])


class Fq2Ops(FqOps):
    """Fq2 elements: (..., 2, 16) Montgomery-domain int32 limbs."""

    name = "fq2"
    deg = 2
    _B3 = _b3_g2_mont()

    def mul(self, a, b):
        return self.mul_many([(a, b)])[0]

    def mul_many(self, pairs):
        """Karatsuba over Fq, all pairs stacked into a single mont_mul.

        For each (a, b): t0 = a0 b0, t1 = a1 b1, t2 = (a0+a1)(b0+b1);
        c0 = t0 - t1, c1 = t2 - t0 - t1.
        """
        lhs, rhs = _stack_pairs(pairs)
        a0, a1 = lhs[..., 0, :], lhs[..., 1, :]
        b0, b1 = rhs[..., 0, :], rhs[..., 1, :]
        prod = self._mul(
            FQ,
            torch.stack([a0, a1, M.add_mod(FQ, a0, a1)]),
            torch.stack([b0, b1, M.add_mod(FQ, b0, b1)]),
        )
        t0, t1, t2 = prod.unbind(0)
        c0 = M.sub_mod(FQ, t0, t1)
        c1 = M.sub_mod(FQ, M.sub_mod(FQ, t2, t0), t1)
        return list(torch.stack([c0, c1], dim=-2).unbind(0))

    def mul_b3(self, x):
        """(3b') * x -- full Fq2 constant multiply (b' = 3/xi is generic)."""
        return self.mul(x, to_tensor(self._B3, x.device).expand(x.shape))

    @staticmethod
    def inv(a):
        """1/a = conj(a) / norm(a), one Fermat inversion in Fq; 0 -> 0."""
        a0, a1 = a[..., 0, :], a[..., 1, :]
        both = torch.stack([a0, a1])
        sq = M.mont_mul(FQ, both, both)
        ninv = M.mont_inv(FQ, M.add_mod(FQ, sq[0], sq[1]))
        c = M.mont_mul(FQ, both, torch.stack([ninv, ninv]))
        return torch.stack([c[0], M.neg_mod(FQ, c[1])], dim=-2)

    @staticmethod
    def is_zero(a):
        return (a == 0).all(-1).all(-1)

    @staticmethod
    def select(mask, a, b):
        return torch.where(mask[..., None, None], a, b)

    @staticmethod
    def zeros(batch_shape, device):
        return torch.zeros(tuple(batch_shape) + (2, NUM_LIMBS), dtype=torch.int32, device=device)

    @staticmethod
    def ones(batch_shape, device):
        return _ones(_mont_one(2, str(device)), batch_shape)


FQ_OPS = FqOps()
FQ2_OPS = Fq2Ops()
FQ_PLAIN = FqOps(plain=True)
FQ2_PLAIN = Fq2Ops(plain=True)


def ops_for(deg: int, plain: bool = False):
    return (FQ_PLAIN if plain else FQ_OPS) if deg == 1 else (FQ2_PLAIN if plain else FQ2_OPS)


# ---------------------------------------------------------------------------
# Complete projective group law (RCB16, a = 0)
# ---------------------------------------------------------------------------


def point_infinity(f, batch_shape, device):
    return (f.zeros(batch_shape, device), f.ones(batch_shape, device), f.zeros(batch_shape, device))


def point_neg(f, p):
    x, y, z = p
    return (x, f.neg(y), z)


def point_select(f, mask, p, q):
    """mask True -> p, False -> q (batched; mask has the batch shape)."""
    return tuple(f.select(mask, a, b) for a, b in zip(p, q))


def point_add(f, p, q):
    """Complete projective add (RCB16 alg. 7): valid for ALL inputs.

    Plain version of kernel K4; the same dataflow as jaxcurve.point_add."""
    x1, y1, z1 = p
    x2, y2, z2 = q

    s0, s1, s2, s3, s4, s5 = f.add_many(
        [(x1, y1), (x2, y2), (y1, z1), (y2, z2), (x1, z1), (x2, z2)]
    )
    t0, t1, t2, m0, m1, m2 = f.mul_many(
        [(x1, x2), (y1, y2), (z1, z2), (s0, s1), (s2, s3), (s4, s5)]
    )
    u01, u12, u02 = f.add_many([(t0, t1), (t1, t2), (t0, t2)])
    t3, t4, t5 = f.sub_many([(m0, u01), (m1, u12), (m2, u02)])
    m = f.add(f.dbl(t0), t0)                  # 3 X1X2
    nb = f.mul_b3(torch.stack([t2, t5]))      # 3b Z1Z2, 3b (X1Z2 + X2Z1)
    n, bv = nb[0], nb[1]
    wmn = f.sub(t1, n)
    wpn = f.add(t1, n)
    p0, p1_, p2_, p3_, p4_, p5_ = f.mul_many(
        [(t3, wmn), (t4, bv), (wpn, wmn), (m, bv), (t4, wpn), (t3, m)]
    )
    x3 = f.sub(p0, p1_)
    y3, z3 = f.add_many([(p2_, p3_), (p4_, p5_)])
    return (x3, y3, z3)


def point_double(f, p):
    """Complete projective doubling (RCB16 alg. 9): valid for ALL inputs.

    Plain version of kernel K5; the same dataflow as jaxcurve.point_double."""
    x, y, z = p
    t0, t1, t2, t3 = f.mul_many([(y, y), (y, z), (z, z), (x, y)])
    z8 = f.dbl(f.dbl(f.dbl(t0)))           # 8 Y^2
    n = f.mul_b3(t2)                       # 3b Z^2
    n3 = f.add(f.dbl(n), n)
    t0m, t0p = f.sub(t0, n3), f.add(t0, n)
    q0, q1, q2, q3 = f.mul_many([(t1, z8), (n, z8), (t0m, t0p), (t0m, t3)])
    return (f.dbl(q3), f.add(q2, q1), q0)


# ---------------------------------------------------------------------------
# Layout conversions: AoS point tuples <-> planes <-> packed rows
# ---------------------------------------------------------------------------


def point_to_planes(f, pt) -> torch.Tensor:
    """(X, Y, Z) with batch (n,) -> (3 deg, 16, n) planes."""
    c = torch.stack(pt)                                   # (3, n, [2,] 16)
    if f.deg == 1:
        return c.permute(0, 2, 1).contiguous()
    return c.permute(0, 2, 3, 1).reshape(6, NUM_LIMBS, c.shape[1]).contiguous()


def planes_to_point(f, planes: torch.Tensor):
    """(3 deg, 16, n) planes -> (X, Y, Z) with batch (n,)."""
    n = planes.shape[-1]
    if f.deg == 1:
        return tuple(planes.permute(0, 2, 1).contiguous().unbind(0))
    c = planes.reshape(3, 2, NUM_LIMBS, n).permute(0, 3, 1, 2).contiguous()
    return tuple(c.unbind(0))


def rows_to_planes(rows: torch.Tensor) -> torch.Tensor:
    """Packed rows (n, 48 deg) -> (3 deg, 16, n) planes."""
    n, width = rows.shape
    return rows.t().contiguous().view(width // NUM_LIMBS, NUM_LIMBS, n)


def planes_to_rows(planes: torch.Tensor) -> torch.Tensor:
    """(3 deg, 16, n) planes -> packed rows (n, 48 deg)."""
    k, _, n = planes.shape
    return planes.reshape(k * NUM_LIMBS, n).t().contiguous()


def point_to_rows(pt) -> torch.Tensor:
    """(X, Y, Z) with batch (n,) -> packed rows (n, 48 deg)."""
    return torch.cat([c.flatten(1) for c in pt], dim=1)


def rows_to_point(deg: int, rows: torch.Tensor):
    """Packed rows (n, 48 deg) -> (X, Y, Z) with batch (n,)."""
    shape = (rows.shape[0], NUM_LIMBS) if deg == 1 else (rows.shape[0], 2, NUM_LIMBS)
    return tuple(c.reshape(shape) for c in rows.split(NUM_LIMBS * deg, dim=1))


def infinity_planes(deg: int, width: int, device) -> torch.Tensor:
    f = ops_for(deg)
    return point_to_planes(f, point_infinity(f, (1,), device)).expand(-1, -1, width).contiguous()


# ---------------------------------------------------------------------------
# Host <-> device conversion
# ---------------------------------------------------------------------------


def host_points_to_proj(f, points, device):
    """List of host CurvePoints (affine or inf) -> batched projective tensors."""
    n = len(points)
    xs, ys, zs = [], [], []
    if f.deg == 1:
        for p in points:
            if p.inf:
                xs.append(0), ys.append(1), zs.append(0)
            else:
                xs.append(p.x.v), ys.append(p.y.v), zs.append(1)
        shape = (n, NUM_LIMBS)
    else:
        for p in points:
            if p.inf:
                xs += [0, 0]
                ys += [1, 0]
                zs += [0, 0]
            else:
                xs += [p.x.c0, p.x.c1]
                ys += [p.y.c0, p.y.c1]
                zs += [1, 0]
        shape = (n, 2, NUM_LIMBS)
    return tuple(
        to_tensor(M.encode_ints(FQ, v).reshape(shape), device) for v in (xs, ys, zs)
    )


def proj_to_host_points(f, proj):
    """Batched projective tensors -> list of host CurvePoints (exact)."""
    xs, ys, zs = (M.decode_ints(FQ, c) for c in proj)
    out = []
    if f.deg == 1:
        for x, y, z in zip(xs, ys, zs):
            if z == 0:
                out.append(CurvePoint.infinity(B_G1))
            else:
                zinv = pow(z, -1, Q)
                out.append(CurvePoint(Fq(x * zinv % Q), Fq(y * zinv % Q), B_G1))
        return out
    for i in range(len(xs) // 2):
        z = Fq2(zs[2 * i], zs[2 * i + 1])
        if z.is_zero():
            out.append(CurvePoint.infinity(B_G2))
            continue
        zinv = z.inverse()
        x = Fq2(xs[2 * i], xs[2 * i + 1])
        y = Fq2(ys[2 * i], ys[2 * i + 1])
        out.append(CurvePoint(x * zinv, y * zinv, B_G2))
    return out


def planes_to_host_points(deg: int, planes: torch.Tensor):
    f = ops_for(deg)
    return proj_to_host_points(f, planes_to_point(f, planes))


# ---------------------------------------------------------------------------
# Batch projective <-> affine on the device (the byte formats' two ends)
# ---------------------------------------------------------------------------


def proj_to_affine_limbs(f, proj):
    """Projective mont points -> (x, y, inf) plain-domain limbs.

    Batched Fermat inversion of Z; infinity rows decode to x = y = 0."""
    x, y, z = proj
    zinv = f.inv(z)                      # 0 -> 0 handles infinity
    xa, ya = f.mul_many([(x, zinv), (y, zinv)])
    return M.from_mont(FQ, xa), M.from_mont(FQ, ya), f.is_zero(z)


def affine_limbs_to_proj(f, x_plain, y_plain, inf_mask):
    """Inverse of proj_to_affine_limbs: plain affine limbs -> mont projective."""
    xm = M.to_mont(FQ, x_plain)
    ym = M.to_mont(FQ, y_plain)
    batch, dev = inf_mask.shape, xm.device
    xm = f.select(inf_mask, f.zeros(batch, dev), xm)
    ym = f.select(inf_mask, f.ones(batch, dev), ym)
    zm = f.select(inf_mask, f.zeros(batch, dev), f.ones(batch, dev))
    return (xm, ym, zm)
