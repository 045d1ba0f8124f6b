"""Complete point add and doubling on (3 deg, 16, n) limb planes: kernels
K4 (point_add) and K5 (point_double).

Counterpart of zklaim_tpu/ec/pallas_curve.py (point_add_planes,
point_add_halves, point_double).  A point batch of width n is one int32
tensor of 3 * deg planes, each (16, n) limbs; G2 planes are
(x0, x1, y0, y1, z0, z1).

On a CUDA tensor each call is one K4 or K5 launch, and a build or launch
that fails raises; on a CPU tensor it runs `point_add_plain` /
`point_double_plain`, the plain versions (curve.point_add,
curve.point_double).

`scalar_mul` is the counterpart of jaxcurve.scalar_mul on planes: the
batched double-and-add ladder, each step one K5, one K4 and a select.

K4's and K5's other entries run the stages of a Pippenger pass: msm.gpu_msm.
"""

from __future__ import annotations

import torch

from .. import kernels as K
from ..ff.limbs import LIMB_BITS, NUM_LIMBS
from . import curve as C


def point_add_plain(deg: int, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Plain version of K4 on planes, on any device."""
    f = C.ops_for(deg, plain=True)
    r = C.point_add(f, C.planes_to_point(f, p), C.planes_to_point(f, q))
    return C.point_to_planes(f, r)


def check_points(deg: int, t: torch.Tensor, what: str) -> None:
    """Raise unless t is a kernel's point operand: int32 CUDA (3 deg, 16, n)
    planes of unit element stride."""
    K.check_planes(t, what)
    unit = t.dim() == 3 and (t.shape[2] <= 1 or t.stride(2) == 1)
    if not unit or t.shape[0] != 3 * deg or t.shape[1] != 16:
        raise ValueError(
            f"{what}: expected ({3 * deg}, 16, n) planes with unit element stride, "
            f"got shape {tuple(t.shape)} strides {t.stride()}"
        )


def point_add_planes(deg: int, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """p + q lane by lane: two (3 deg, 16, n) plane sets -> a new one."""
    if not p.is_cuda:
        return point_add_plain(deg, p, q)
    check_points(deg, p, "point_add p")
    check_points(deg, q, "point_add q")
    dev = K.launch_device("point_add", p, q)
    if p.shape != q.shape:
        raise ValueError(f"point_add: operand mismatch {tuple(p.shape)} vs {tuple(q.shape)}")
    n = p.shape[2]
    out = torch.empty((3 * deg, 16, n), dtype=torch.int32, device=dev)
    if n:
        K.launch("point_add", deg,
                 p.data_ptr(), p.stride(0), p.stride(1),
                 q.data_ptr(), q.stride(0), q.stride(1),
                 out.data_ptr(), out.stride(0), out.stride(1), n, device=dev)
    return out


def point_add_halves(deg: int, planes: torch.Tensor) -> torch.Tensor:
    """Sum of the contiguous halves: (3 deg, 16, w) -> (3 deg, 16, w/2).

    The halves are two strided views of `planes`: no copy on either device."""
    w = planes.shape[-1]
    if w % 2:
        raise ValueError(f"point_add_halves: odd width {w}")
    return point_add_planes(deg, planes[..., : w // 2], planes[..., w // 2 :])


def point_double_plain(deg: int, p: torch.Tensor) -> torch.Tensor:
    """Plain version of K5 on planes, on any device."""
    f = C.ops_for(deg, plain=True)
    return C.point_to_planes(f, C.point_double(f, C.planes_to_point(f, p)))


def point_double_planes(deg: int, p: torch.Tensor) -> torch.Tensor:
    """2p lane by lane: (3 deg, 16, n) planes -> a new plane set."""
    if not p.is_cuda:
        return point_double_plain(deg, p)
    check_points(deg, p, "point_double p")
    dev = K.launch_device("point_double", p)
    n = p.shape[2]
    out = torch.empty((3 * deg, 16, n), dtype=torch.int32, device=dev)
    if n:
        K.launch("point_double", deg,
                 p.data_ptr(), p.stride(0), p.stride(1),
                 out.data_ptr(), out.stride(0), out.stride(1), n, device=dev)
    return out


def scalar_mul(deg: int, planes: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """Batched double-and-add: scalars[i] * point[i] -> (3 deg, 16, n) planes.

    planes: (3 deg, 16, n) points; scalars: (n, 16) plain-domain (NOT
    Montgomery) int32 limbs.  256 steps, MSB first, the dataflow of
    jaxcurve.scalar_mul: double (K5), add the point (K4), keep the sum where
    the scalar's bit is set."""
    n = planes.shape[2]
    if scalars.shape != (n, NUM_LIMBS):
        raise ValueError(f"scalar_mul: {n} points with scalars {tuple(scalars.shape)}")
    acc = C.infinity_planes(deg, n, planes.device)
    for bit_index in range(255, -1, -1):
        bit = (scalars[:, bit_index // LIMB_BITS] >> (bit_index % LIMB_BITS)) & 1
        acc = point_double_planes(deg, acc)
        acc = torch.where(bit == 1, point_add_planes(deg, acc, planes), acc)
    return acc
