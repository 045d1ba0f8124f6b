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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from zklaim_tpu.ec.hostcurve import g1_generator, g2_generator
from zklaim_tpu.ff.params import R

from ..ec import curve as C
from ..ec import gpu_curve as G
from ..ff import montgomery as M
from ..ff.limbs import ints_to_limbs, to_tensor
from ..ff.montgomery import FQ, FR
from ..ntt import gpu_ntt
from ..ntt.radix2 import get_domain


@dataclass
class Case:
    kernel: str                        # key of kernels.LAUNCHES
    label: str
    run: Callable[[], torch.Tensor]    # launches the kernel
    plain: Callable[[], torch.Tensor]  # the plain version, same inputs


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
    """The four kernels at the given widths (defaults: the main path's)."""
    rng = np.random.default_rng(seed)
    cases = []
    for spec in (FR, FQ):
        a, b = (random_field(spec, n_field, rng, device) for _ in range(2))
        cases.append(Case("mont_mul", f"K1 mont_mul {spec.name} n={n_field}",
                          lambda s=spec, a=a, b=b: M.mont_mul(s, a, b),
                          lambda s=spec, a=a, b=b: M.mont_mul_plain(s, a, b)))

    dom = get_domain(n_ntt, str(device))
    x = random_field(FR, n_ntt, rng, device).t().contiguous()     # (16, n) planes
    lt = min(gpu_ntt.TILE, n_ntt).bit_length() - 1
    for tw, name in ((dom.tw_flat, "forward"), (dom.tw_inv_flat, "inverse")):
        cases.append(Case("ntt_local", f"K2 ntt_local {name} n={n_ntt}",
                          lambda tw=tw: gpu_ntt.ntt_local(x.clone(), tw),
                          lambda tw=tw: gpu_ntt.ntt_plain(x, tw, range(lt))))
        if dom.k > lt:
            cases.append(Case("ntt_stage", f"K3 ntt_stage {name} n={n_ntt}",
                              lambda tw=tw: gpu_ntt.ntt_global(x.clone(), tw),
                              lambda tw=tw: gpu_ntt.ntt_plain(x, tw, range(lt, dom.k))))

    for deg, n in ((1, n_g1), (2, n_g2)):
        p, q = curve_inputs(deg, n, rng, device)
        cases.append(Case("point_add", f"K4 point_add G{deg} n={n}",
                          lambda d=deg, p=p, q=q: G.point_add_planes(d, p, q),
                          lambda d=deg, p=p, q=q: G.point_add_plain(d, p, q)))
    p, _ = curve_inputs(1, n_g1, rng, device)
    cases.append(Case("point_add", f"K4 point_add_halves G1 n={n_g1}",
                      lambda: G.point_add_halves(1, p),
                      lambda: G.point_add_plain(1, p[..., : n_g1 // 2], p[..., n_g1 // 2 :])))
    return cases


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest limb difference (0 when the two results are identical)."""
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0
