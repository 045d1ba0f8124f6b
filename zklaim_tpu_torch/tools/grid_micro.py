"""Cost of CTA granularity: the same G1 point add over 2^15 lanes, cut into
ever fewer, larger CTAs: kernel K8 (point_add_tiled).

Counterpart of tools/grid_micro.py, which reads the overhead of a Pallas
grid step from the same sweep.  K8 launches ceil(N / tile) CTAs, one a
tile, each of tiled_threads(tile) = min(tile, 384) threads: as many as one
SM holds at the kernel's 140 registers a thread, so a tile's CTA fills its
SM and walks its `tile` lanes with them.  tile = 128 is kernel K4's own cut
(one lane a thread, 256 CTAs for the card's 132 SMs); the original's tiles
follow, 512, 2048, 8192 and N: 64, 16, 4 CTAs, and one CTA that owns every
lane and so runs on one SM.  The arithmetic is the same in every row
(csrc/rcb.cuh's rcb_add, as in K4), so the rows differ only by how many SMs
the launch can occupy.

Inputs are points on the curve (the original draws raw limbs; the complete
formulas run the same arithmetic on either).

    python -m zklaim_tpu_torch.tools.grid_micro [--device cpu]

On the CPU every tile runs the one plain version by the host clock: a drive
of the control flow, and the row says "cpu".
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import kernels as K
from .. import resolve_device
from ..ec.gpu_curve import point_add_plain
from ..kernels.cases import curve_inputs
from ..utils.profiling import best_ms, card_label

N = 1 << 15
TILES = (128, 512, 2048, 8192, N)
SEED = 0
# csrc/probes.cu's TILED_MAX_THREADS, its __launch_bounds__: the threads an
# SM holds at the kernel's register count (12 warps at 140 registers)
TILED_MAX_THREADS = 384


def tiled_threads(tile: int) -> int:
    """Threads of K8's CTA for a tile of `tile` lanes: the tile, up to what
    one SM holds."""
    if tile < 1:
        raise ValueError(f"point_add_tiled: tile {tile}")
    return min(tile, TILED_MAX_THREADS)


def point_add_tiled_plain(p: torch.Tensor, q: torch.Tensor, tile: int) -> torch.Tensor:
    """Plain version of K8 on any device: the tile cuts the launch, not the
    function, so this is point_add_plain for every tile."""
    if tile < 1:
        raise ValueError(f"point_add_tiled: tile {tile}")
    return point_add_plain(1, p, q)


def point_add_tiled(p: torch.Tensor, q: torch.Tensor, tile: int) -> torch.Tensor:
    """p + q lane by lane on (3, 16, n) G1 planes, as ceil(n / tile) CTAs of
    tiled_threads(tile) threads: one K8 launch on CUDA, the plain version on
    the CPU."""
    if not p.is_cuda:
        return point_add_tiled_plain(p, q, tile)
    for t, what in ((p, "point_add_tiled p"), (q, "point_add_tiled q")):
        K.check_planes(t, what)
        if t.dim() != 3 or t.shape[:2] != (3, 16) or (t.shape[2] > 1 and t.stride(2) != 1):
            raise ValueError(f"{what}: expected (3, 16, n) planes with unit element stride, "
                             f"got shape {tuple(t.shape)} strides {t.stride()}")
    dev = K.launch_device("point_add_tiled", p, q)
    if p.shape != q.shape or tile < 1:
        raise ValueError(f"point_add_tiled: {tuple(p.shape)} vs {tuple(q.shape)}, tile {tile}")
    n = p.shape[2]
    out = torch.empty((3, 16, n), dtype=torch.int32, device=dev)
    if n:
        K.launch("point_add_tiled",
                 p.data_ptr(), p.stride(0), p.stride(1),
                 q.data_ptr(), q.stride(0), q.stride(1),
                 out.data_ptr(), out.stride(0), out.stride(1), n, tile, tiled_threads(tile),
                 device=dev)
    return out


def measure(device, n: int = N, tiles=TILES) -> list:
    """One row per tile: milliseconds of the launch and ns per lane."""
    device = torch.device(device)
    p, q = curve_inputs(1, n, np.random.default_rng(SEED), device)
    rows = []
    for tile in dict.fromkeys(min(t, n) for t in tiles):
        ms = best_ms(lambda: point_add_tiled(p, q, tile), device)
        rows.append({
            "probe": "grid_micro", "kernel": "point_add_tiled", "device": card_label(device),
            "lanes": n, "tile": tile, "ctas": -(-n // tile), "threads": tiled_threads(tile),
            "ms": ms,
            "ns_per_lane": ms * 1e6 / n,
        })
    return rows


def format_row(r: dict) -> str:
    return (f"[{r['device']}] tile={r['tile']:6d} grid={r['ctas']:4d} x {r['threads']:3d} threads: "
            f"{r['ms']:9.4f} ms "
            f"({r['ns_per_lane']:.2f} ns/lane)")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args()
    device = resolve_device(args.device)
    n = N if device.type == "cuda" else 256
    for row in measure(device, n):
        print(format_row(row), flush=True)


if __name__ == "__main__":
    main()
