"""Cost of one Montgomery product on the card: kernel K6 (mont_chain),
differenced over two chain lengths.

Counterpart of tools/mont_micro.py.  K6 runs K chained squarings
v <- mont_mul(v, v) over Fq with each lane's element held in registers (one
load, one store), so (t(K2) - t(K1)) / (K2 - K1) is the cost of one product
step with launch, load and store cancelled.  It is measured at the original's
shape, (16, 1024) planes -- 32 warps, which K6 spreads over 32 SMs, one
warp each -- and at a width that fills the card, WIDE_LANES = 4 x 132 SMs x
2,048 threads, in CTAs of 256 threads, 8 an SM: the second gives the product
rate of the whole card, the number a bound on the other kernels' arithmetic
should rest on.  chain_threads gives the launch.

Inputs are residues below p (the original draws raw 16-bit limbs, which may
exceed p; there its multiply and this one agree only after the first step).

    python -m zklaim_tpu_torch.tools.mont_micro [--device cpu]

On the CPU the plain version runs at K = 2 and 6 by the host clock: a drive
of the control flow, and the row says "cpu".
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import kernels as K
from .. import resolve_device
from ..ff import montgomery as M
from ..ff.montgomery import FQ
from ..kernels.cases import MADS_PER_PRODUCT, random_field
from ..utils.profiling import best_ms, card_label
from . import padd_micro

LANES = 1024
WIDE_LANES = 4 * 132 * 2048
CHAIN = (64, 512)
CHAIN_CPU = (2, 6)
SEED = 0

CHAIN_MAX_THREADS = 256      # csrc/probes.cu's MONT_CHAIN_MAX_THREADS, its __launch_bounds__


def chain_threads(n: int, sms: int) -> int:
    """Threads of K6's CTA for n lanes on a card of `sms` SMs, one lane a
    thread: padd_micro.chain_threads, K9's rule, at K6's cap.  1,024 lanes
    at 132 SMs: CTAs of one warp, 32 of them; WIDE_LANES: CTAs of 256,
    4,224 of them, 8 an SM.  The launcher (csrc/probes.cu:zk_mont_chain)
    cuts the lanes into ceil(n / threads) CTAs."""
    return padd_micro.chain_threads(n, sms, CHAIN_MAX_THREADS)


def mont_chain_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version of K6 on any device: (16, n) Fq planes, k squarings."""
    v = x.t().contiguous()
    for _ in range(k):
        v = M.mont_mul_plain(FQ, v, v)
    return v.t().contiguous()


def mont_chain(x: torch.Tensor, k: int) -> torch.Tensor:
    """k chained Montgomery squarings of every lane of (16, n) Fq planes
    (canonical limbs): one K6 launch on CUDA in CTAs of chain_threads' size,
    the plain version on the CPU."""
    if not x.is_cuda:
        return mont_chain_plain(x, k)
    dev = K.launch_device("mont_chain", x)
    if x.dim() != 2 or x.shape[0] != 16 or (x.shape[1] > 1 and x.stride(1) != 1) or k < 0:
        raise ValueError(f"mont_chain: expected (16, n) planes with unit element stride and "
                         f"k >= 0, got shape {tuple(x.shape)} strides {x.stride()} k {k}")
    n = x.shape[1]
    out = torch.empty((16, n), dtype=torch.int32, device=dev)
    if n:
        K.launch("mont_chain", x.data_ptr(), x.stride(0), out.data_ptr(), out.stride(0), n, k,
                 chain_threads(n, K.sm_count(dev)), device=dev)
    return out


def probe_input(lanes: int, device) -> torch.Tensor:
    """(16, lanes) planes of residues below p: 2^14 distinct ones, tiled."""
    base = random_field(FQ, min(lanes, 1 << 14), np.random.default_rng(SEED), device)
    reps = -(-lanes // base.shape[0])
    return base.repeat(reps, 1)[:lanes].t().contiguous()


def measure(device, widths=(LANES, WIDE_LANES)) -> list:
    """One row per width: the differenced cost of a product step."""
    device = torch.device(device)
    k1, k2 = CHAIN if device.type == "cuda" else CHAIN_CPU
    rows = []
    for lanes in widths:
        x = probe_input(lanes, device)
        t1 = best_ms(lambda: mont_chain(x, k1), device)
        t2 = best_ms(lambda: mont_chain(x, k2), device)
        step_ms = (t2 - t1) / (k2 - k1)
        rows.append({
            "probe": "mont_micro", "kernel": "mont_chain", "device": card_label(device),
            "lanes": lanes, "k1": k1, "k2": k2, "t1_ms": t1, "t2_ms": t2,
            "us_per_step": step_ms * 1e3,
            "ns_per_lane": step_ms * 1e6 / lanes,
            "products_per_s": lanes / (step_ms * 1e-3),
            "mads_per_s": MADS_PER_PRODUCT * lanes / (step_ms * 1e-3),
        })
    return rows


def format_row(r: dict) -> str:
    return (f"[{r['device']}] t1={r['t1_ms']:.3f}ms t2={r['t2_ms']:.3f}ms  mont_mul: "
            f"{r['us_per_step']:.3f} us per (16,{r['lanes']}) block = {r['ns_per_lane']:.4f} ns/lane"
            f"  ({r['products_per_s'] / 1e6:.1f} M muls/s, "
            f"{r['mads_per_s'] / 1e12:.3f} T 32-bit multiply-adds/s)")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args()
    device = resolve_device(args.device)
    widths = (LANES, WIDE_LANES) if device.type == "cuda" else (LANES,)
    for row in measure(device, widths):
        print(format_row(row), flush=True)


if __name__ == "__main__":
    main()
