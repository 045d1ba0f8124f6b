"""Cost of one complete G1 point add on the card: kernel K9
(point_add_chain), differenced over two chain lengths.

Counterpart of tools/padd_micro.py.  K9 runs K chained adds pt <- pt + pt
with each lane's point held in registers (one load, one store), so
(t(K2) - t(K1)) / (K2 - K1) is the cost of one add step -- csrc/rcb.cuh's
rcb_add, the function kernel K4 runs: 12 Fq products and some twenty
modular additions -- with launch, load and store cancelled.  Measured at the
original's shape, 1024 lanes (32 warps), and at WIDE_LANES, which fills the
card.  The lanes go to CTAs of chain_threads(n, SMs) threads: as few warps a
CTA as spread them over every SM (1,024 lanes: 32 CTAs of one warp), up to
256.

Inputs are points on the curve (the original draws raw limbs).

    python -m zklaim_tpu_torch.tools.padd_micro [--device cpu]

On the CPU the plain version runs at K = 1 and 3 on 64 lanes by the host
clock: a drive of the control flow, and the row says "cpu".
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import kernels as K
from .. import resolve_device
from ..ec.gpu_curve import point_add_plain
from ..kernels.cases import ADD_PRODUCTS, MADS_PER_PRODUCT, random_points
from ..utils.profiling import best_ms, card_label

LANES = 1024
WIDE_LANES = 4 * 132 * 2048
CHAIN = (16, 128)
CHAIN_CPU = (1, 3)
SEED = 0
CHAIN_MAX_THREADS = 256          # csrc/probes.cu's CHAIN_MAX_THREADS, its __launch_bounds__


def chain_threads(n: int, sms: int, cap: int = CHAIN_MAX_THREADS) -> int:
    """Threads a CTA for a chain probe's n lanes, one lane a thread, on a card
    of `sms` SMs: the fewest whole warps a CTA that put every lane on one of
    at most `sms` CTAs, one CTA an SM, and at most `cap` threads (the
    kernel's __launch_bounds__) where the lanes are more.  K9's rule at its
    own cap; K6 (mont_micro.chain_threads) runs by it at its own."""
    warps = -(-n // 32)
    return 32 * max(1, min(-(-warps // sms), cap // 32))


def point_add_chain_plain(p: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version of K9 on any device: k times pt <- pt + pt."""
    for _ in range(k):
        p = point_add_plain(1, p, p)
    return p.clone() if k == 0 else p


def point_add_chain(p: torch.Tensor, k: int) -> torch.Tensor:
    """k chained complete adds pt <- pt + pt on (3, 16, n) G1 planes: one K9
    launch on CUDA, the plain version on the CPU."""
    if not p.is_cuda:
        return point_add_chain_plain(p, k)
    dev = K.launch_device("point_add_chain", p)
    if (p.dim() != 3 or p.shape[:2] != (3, 16) or (p.shape[2] > 1 and p.stride(2) != 1)
            or k < 0):
        raise ValueError(f"point_add_chain: expected (3, 16, n) planes with unit element "
                         f"stride and k >= 0, got shape {tuple(p.shape)} strides {p.stride()} k {k}")
    n = p.shape[2]
    out = torch.empty((3, 16, n), dtype=torch.int32, device=dev)
    if n:
        K.launch("point_add_chain", p.data_ptr(), p.stride(0), p.stride(1),
                 out.data_ptr(), out.stride(0), out.stride(1), n, k,
                 chain_threads(n, K.sm_count(dev)), device=dev)
    return out


def probe_input(lanes: int, device) -> torch.Tensor:
    """(3, 16, lanes) planes of curve points: 2^14 random lanes, tiled."""
    base = random_points(1, min(lanes, 1 << 14), np.random.default_rng(SEED), device)
    reps = -(-lanes // base.shape[2])
    return base.repeat(1, 1, reps)[..., :lanes].contiguous()


def measure(device, widths=(LANES, WIDE_LANES)) -> list:
    """One row per width: the differenced cost of an add step."""
    device = torch.device(device)
    k1, k2 = CHAIN if device.type == "cuda" else CHAIN_CPU
    sms = K.sm_count(device) if device.type == "cuda" else 0
    rows = []
    for lanes in widths:
        p = probe_input(lanes, device)
        t1 = best_ms(lambda: point_add_chain(p, k1), device)
        t2 = best_ms(lambda: point_add_chain(p, k2), device)
        step_ms = (t2 - t1) / (k2 - k1)
        rows.append({
            "probe": "padd_micro", "kernel": "point_add_chain", "device": card_label(device),
            "lanes": lanes, "threads": chain_threads(lanes, sms) if sms else None,
            "k1": k1, "k2": k2, "t1_ms": t1, "t2_ms": t2,
            "us_per_step": step_ms * 1e3,
            "ns_per_lane": step_ms * 1e6 / lanes,
            "adds_per_s": lanes / (step_ms * 1e-3),
            "mads_per_s": ADD_PRODUCTS[1] * MADS_PER_PRODUCT * lanes / (step_ms * 1e-3),
        })
    return rows


def format_row(r: dict) -> str:
    return (f"[{r['device']}] t1={r['t1_ms']:.3f}ms t2={r['t2_ms']:.3f}ms  point_add: "
            f"{r['us_per_step']:.3f} us per (,{r['lanes']}) block"
            f"{'' if r['threads'] is None else ' in CTAs of %d threads' % r['threads']}"
            f" = {r['ns_per_lane']:.4f} ns/lane"
            f"  ({r['adds_per_s'] / 1e6:.2f} M adds/s, "
            f"{r['mads_per_s'] / 1e12:.3f} T 32-bit multiply-adds/s in products)")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args()
    device = resolve_device(args.device)
    widths = (LANES, WIDE_LANES) if device.type == "cuda" else (64,)
    for row in measure(device, widths):
        print(format_row(row), flush=True)


if __name__ == "__main__":
    main()
