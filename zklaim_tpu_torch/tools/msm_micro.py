"""Microbenchmark of the MSM's building blocks on one device, at the shape
of one flat batch cut as (W, N) = (32 windows, 4096 lanes).

Counterpart of tools/msm_micro.py: one full-width point add (kernel K4), 12
chained adds, the 12 rounds of a roll + add + select prefix scan and of the
rolls alone, a sort with its gather (along the lane axis, and as one flat
row gather), a batched searchsorted, and 256 chained doublings of one lane
(kernel K5: the cost model of the Horner finish).  Times by CUDA events on
the card.

    python -m zklaim_tpu_torch.tools.msm_micro [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import resolve_device
from ..utils.profiling import best_ms, card_label

W, N = 32, 1 << 12


def measure(device, w: int = W, n: int = N, rounds: int = 12, doublings: int = 256) -> list:
    """One row per building block: its name and milliseconds."""
    from ..ec.gpu_curve import point_add_planes, point_double_planes
    from ..kernels.cases import random_points

    device = torch.device(device)
    rng = np.random.default_rng(0)
    planes = random_points(1, w * n, rng, device)                     # (3, 16, w n)
    grid = planes.view(3, 16, w, n)
    keys = torch.from_numpy(rng.integers(0, 128, size=(w, n))).to(device)
    skeys, order = torch.sort(keys, dim=1, stable=True)
    lane = torch.arange(n, device=device)
    buckets = torch.arange(129, device=device).expand(w, 129).contiguous()
    one = planes[..., :1].contiguous()

    def add(p):
        return point_add_planes(1, p, p)

    def add_pair(p, q):
        return point_add_planes(1, p, q)

    def adds(p):
        for _ in range(rounds):
            p = add(p)
        return p

    def prefix(g):
        for t in range(rounds):
            d = 1 << t
            sh = torch.roll(g, d, dims=3).reshape(3, 16, w * n)
            g = torch.where(lane >= d, add_pair(g.reshape(3, 16, w * n), sh).view(3, 16, w, n), g)
        return g

    def rolls(g):
        for t in range(rounds):
            g = torch.roll(g, 1 << t, dims=3)
        return g

    def sort_gather_lanes():
        _, o = torch.sort(keys, dim=1, stable=True)
        return torch.take_along_dim(grid, o[None, None], dim=3)

    def sort_gather_flat():
        _, o = torch.sort(keys, dim=1, stable=True)
        flat = (o + torch.arange(w, device=device)[:, None] * n).reshape(-1)
        return planes.index_select(2, flat)

    def doubles(p):
        for _ in range(doublings):
            p = point_double_planes(1, p)
        return p

    blocks = [
        ("point_add (W,N)", lambda: add(planes)),
        (f"{rounds}x point_add (W,N)", lambda: adds(planes)),
        (f"{rounds}x roll+add+select (W,N)", lambda: prefix(grid)),
        (f"{rounds}x roll (W,N)", lambda: rolls(grid)),
        ("sort + take_along_dim (W,N)", sort_gather_lanes),
        ("sort + flat index_select (W,N)", sort_gather_flat),
        ("batched searchsorted", lambda: torch.searchsorted(skeys, buckets, right=True)),
        (f"{doublings}x double of one lane", lambda: doubles(one)),
    ]
    return [{"probe": "msm_micro", "device": card_label(device), "w": w, "n": n,
             "block": name, "ms": best_ms(fn, device)} for name, fn in blocks]


def format_row(r: dict) -> str:
    return f"[{r['device']}] {r['block']:34s} {r['ms']:9.3f} ms"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args()
    device = resolve_device(args.device)
    small = {} if device.type == "cuda" else {"w": 2, "n": 8, "rounds": 2, "doublings": 4}
    for row in measure(device, **small):
        print(format_row(row), flush=True)


if __name__ == "__main__":
    main()
