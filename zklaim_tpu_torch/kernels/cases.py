"""Kernel-versus-plain cases at the main path's shapes.

Each Case holds a kernel call and the plain PyTorch version of the same
function on the same inputs, made from a numpy seed.  The card tests
(tests/test_torch_kernels_cuda.py) and chip_smoke.py run them: the two
results must be equal limb for limb (integer arithmetic: tolerance 0).

Inputs: random field elements below p; random curve points as host
multiples of the generator (a small pool, gathered to the lane count),
each lane rescaled by a random Fq factor lambda so the projective
coordinates differ lane to lane, with infinity, P + P and P + (-P) lanes
mixed in.

Each Case also carries the work of its call, from which `bound_ms` gives
the least time the card could take for it: the larger of
  - bytes / HBM_BYTES_PER_S: each input read once and each output written
    once, FE_BYTES = 64 bytes per stored field element (16 int32 limbs);
  - multiply-adds / INT32_MAD_PER_S: MADS_PER_PRODUCT 32-bit multiply-adds
    per Montgomery product (csrc/field.cuh's CIOS: 8 rounds of 8 for
    a * b[i], 1 for m = t[0] n', 8 for m * p), times the products per
    element, butterfly or lane.
The data sheet lists no int32 peak for the H100.  Hopper issues int32 on
half of its FP32 lanes, so the rate is taken as the FP32 peak of
67 TFLOP/s, over 2 (an FMA counts as two operations), over 2 again:
16.75e12 multiply-adds per second at the card's full 700 W limit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..ec import curve as C
from ..ec import gpu_curve as G
from ..ec.hostcurve import g1_generator, g2_generator
from ..ff import montgomery as M
from ..ff.limbs import ints_to_limbs, to_tensor
from ..ff.montgomery import FQ, FR
from ..ntt import gpu_ntt
from ..ntt.radix2 import get_domain


HBM_BYTES_PER_S = 3.35e12
INT32_MAD_PER_S = 67e12 / 2 / 2
FE_BYTES = 64
MADS_PER_PRODUCT = 8 * (8 + 1 + 8)
# Fq products per lane: K4 has 12 field products, K5 has 8; over Fq2 each is
# 3 Fq products (Karatsuba), and 3b is a full Fq2 constant product (twice in
# K4, once in K5), where over Fq it is an addition chain.
ADD_PRODUCTS = {1: 12, 2: 12 * 3 + 2 * 3}
DOUBLE_PRODUCTS = {1: 8, 2: 8 * 3 + 3}


@dataclass
class Case:
    kernel: str                        # key of kernels.LAUNCHES
    label: str
    run: Callable[[], torch.Tensor]    # launches the kernel
    plain: Callable[[], torch.Tensor]  # the plain version, same inputs
    elements_moved: int                # field elements read once + written once
    products: int                      # Montgomery products of the call


def bound_ms(case: Case) -> tuple[float, str]:
    """(least milliseconds the card could take for the case's work, the
    side that sets it: "bytes" or "operations")."""
    by_bytes = case.elements_moved * FE_BYTES / HBM_BYTES_PER_S * 1e3
    by_ops = case.products * MADS_PER_PRODUCT / INT32_MAD_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def random_field(spec, n: int, rng: np.random.Generator, device) -> torch.Tensor:
    """(n, 16) int32 canonical limbs of uniform residues mod p."""
    words = rng.integers(0, 1 << 63, size=(n, 5), dtype=np.int64).tolist()
    vals = [
        (w[0] | w[1] << 63 | w[2] << 126 | w[3] << 189 | w[4] << 252) % spec.p
        for w in words
    ]
    vals[:4] = [0, 1, spec.p - 1, spec.p - 2][: len(vals)]
    return to_tensor(ints_to_limbs(vals), device)


def random_points(deg: int, n: int, rng: np.random.Generator, device,
                  pool: int = 32) -> torch.Tensor:
    """(3 deg, 16, n) planes of random projective points."""
    gen = g1_generator() if deg == 1 else g2_generator()
    f = C.ops_for(deg, plain=True)
    host = [gen * int(rng.integers(1, 1 << 62)) * int(rng.integers(1, 1 << 62))
            for _ in range(pool - 1)]
    host.append(host[0].infinity(gen.b))
    base = C.point_to_planes(f, C.host_points_to_proj(f, host, device))
    idx = torch.from_numpy(rng.integers(0, pool, size=n)).to(device)
    planes = base.index_select(2, idx)
    lam = random_field(FQ, n, rng, device)
    lam[lam.eq(0).all(-1)] = to_tensor(FQ.one_mont, device)
    aos = planes.view(3 * deg, 16, n).transpose(1, 2)          # (3 deg, n, 16)
    return M.mont_mul_plain(FQ, aos, lam).transpose(1, 2).contiguous()


def _neg_lanes(deg: int, planes: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    out = planes.clone()
    y = planes[deg : 2 * deg].transpose(1, 2)
    out[deg : 2 * deg] = torch.where(mask[:, None], M.neg_mod(FQ, y), y).transpose(1, 2)
    return out


def curve_inputs(deg: int, n: int, rng: np.random.Generator, device):
    """(p, q) plane sets: random lanes, with every 8th lane q = p, every
    8th (offset 1) q = -p, and infinity wherever the pool drew it."""
    p = random_points(deg, n, rng, device)
    q = random_points(deg, n, rng, device)
    lane = torch.arange(n, device=device)
    q = torch.where((lane % 8 == 0), p, q)
    q = torch.where((lane % 8 == 1), _neg_lanes(deg, p, lane % 8 == 1), q)
    return p, q


def kernel_cases(device, n_field: int = 1 << 15, n_ntt: int = 1 << 15,
                 n_g1: int = 1 << 16, n_g2: int = 1 << 15, seed: int = 0) -> list:
    """The five kernels at the given widths (defaults: the main path's;
    the doubling also at the MSM finish's own widths, 4 G1 lanes and 1 G2
    lane)."""
    rng = np.random.default_rng(seed)
    cases = []
    for spec in (FR, FQ):
        a, b = (random_field(spec, n_field, rng, device) for _ in range(2))
        cases.append(Case("mont_mul", f"K1 mont_mul {spec.name} n={n_field}",
                          lambda s=spec, a=a, b=b: M.mont_mul(s, a, b),
                          lambda s=spec, a=a, b=b: M.mont_mul_plain(s, a, b),
                          3 * n_field, n_field))

    dom = get_domain(n_ntt, str(device))
    x = random_field(FR, n_ntt, rng, device).t().contiguous()     # (16, n) planes
    lt = min(gpu_ntt.TILE, n_ntt).bit_length() - 1
    # a run of stages reads and writes the n elements once and reads the
    # twiddles of its stages (2^s at stage s); one product per butterfly
    for tw, name in ((dom.tw_flat, "forward"), (dom.tw_inv_flat, "inverse")):
        cases.append(Case("ntt_local", f"K2 ntt_local {name} n={n_ntt}",
                          lambda tw=tw: gpu_ntt.ntt_local(x.clone(), tw),
                          lambda tw=tw: gpu_ntt.ntt_plain(x, tw, range(lt)),
                          2 * n_ntt + (1 << lt) - 1, lt * n_ntt // 2))
        if dom.k > lt:
            cases.append(Case("ntt_stage", f"K3 ntt_stage {name} n={n_ntt}",
                              lambda tw=tw: gpu_ntt.ntt_global(x.clone(), tw),
                              lambda tw=tw: gpu_ntt.ntt_plain(x, tw, range(lt, dom.k)),
                              2 * n_ntt + (1 << dom.k) - (1 << lt), (dom.k - lt) * n_ntt // 2))

    for deg, n in ((1, n_g1), (2, n_g2)):
        p, q = curve_inputs(deg, n, rng, device)
        cases.append(Case("point_add", f"K4 point_add G{deg} n={n}",
                          lambda d=deg, p=p, q=q: G.point_add_planes(d, p, q),
                          lambda d=deg, p=p, q=q: G.point_add_plain(d, p, q),
                          9 * deg * n, ADD_PRODUCTS[deg] * n))
    p, _ = curve_inputs(1, n_g1, rng, device)
    cases.append(Case("point_add", f"K4 point_add_halves G1 n={n_g1}",
                      lambda p=p: G.point_add_halves(1, p),
                      lambda p=p: G.point_add_plain(1, p[..., : n_g1 // 2], p[..., n_g1 // 2 :]),
                      9 * n_g1 // 2, ADD_PRODUCTS[1] * n_g1 // 2))

    for deg, n in ((1, n_g1), (2, n_g2), (1, 4), (2, 1)):
        p = random_points(deg, n, rng, device)
        cases.append(Case("point_double", f"K5 point_double G{deg} n={n}",
                          lambda d=deg, p=p: G.point_double_planes(d, p),
                          lambda d=deg, p=p: G.point_double_plain(d, p),
                          6 * deg * n, DOUBLE_PRODUCTS[deg] * n))
    return cases


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest limb difference (0 when the two results are identical)."""
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0
