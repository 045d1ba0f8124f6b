"""Layout overheads around the point-add kernel K4, G1 at n = 2^20.

Counterpart of tools/layout_probe.py.  What it answers on the card:
  1. ns/lane of ONE add on AoS (n, 16) coordinates: the planes are built
     and taken apart around the launch (the cost an AoS interface pays);
  2. ns/lane of the same add on (3, 16, n) planes (the kernel's layout);
  3. the (n, 16) -> (16, n) transposes alone;
  4. a row gather on three (n, 16) arrays against one packed (n, 48) array
     (the MSM's table gather), and a lane gather on planes;
  5. the copies a strided or half slice would cost -- K4 takes strided views,
     so the MSM's halves pay none of them.

    python -m zklaim_tpu_torch.tools.layout_probe [--log2n 20] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import resolve_device
from ..utils.profiling import best_ms, card_label


def measure(device, log2n: int = 20, runs: int = 5) -> list:
    """One row per operation: milliseconds, and ns/lane for the adds."""
    from ..bench import make_points
    from ..ec import curve as C
    from ..ec.gpu_curve import point_add_planes

    device = torch.device(device)
    n = 1 << log2n
    f = C.FQ_OPS
    rows_p = make_points(1, n, device)
    p = C.rows_to_point(1, rows_p)                                   # AoS (n, 16) x 3
    p = tuple(c.contiguous() for c in p)
    q = tuple(torch.roll(c, 7, dims=0) for c in p)
    p_pl, q_pl = C.point_to_planes(f, p), C.point_to_planes(f, q)
    order = torch.from_numpy(np.random.default_rng(0).permutation(n)).to(device)

    ops = [
        ("K4 add, AoS in/out", True,
         lambda: C.planes_to_point(f, point_add_planes(1, C.point_to_planes(f, p),
                                                       C.point_to_planes(f, q)))),
        ("K4 add, planes in/out", True, lambda: point_add_planes(1, p_pl, q_pl)),
        ("transpose (n,16)->(16,n) x3", False, lambda: [c.t().contiguous() for c in p]),
        ("row gather 3x(n,16)", False, lambda: [c.index_select(0, order) for c in p]),
        ("row gather (n,48) packed", False, lambda: rows_p.index_select(0, order)),
        ("lane gather (3,16,n)", False, lambda: p_pl.index_select(2, order)),
        ("even slice 3x(n,16)[0::2] copy", False, lambda: [c[0::2].contiguous() for c in p]),
        ("even slice (3,16,n)[...,0::2] copy", False, lambda: p_pl[..., 0::2].contiguous()),
        ("half slice (3,16,n)[...,:n/2] copy", False, lambda: p_pl[..., : n // 2].contiguous()),
    ]
    out = []
    for name, per_lane, fn in ops:
        ms = best_ms(fn, device, runs)
        row = {"probe": "layout_probe", "device": card_label(device), "log2n": log2n,
               "op": name, "ms": ms}
        if per_lane:
            row["ns_per_lane"] = ms * 1e6 / n
        out.append(row)
    return out


def format_row(r: dict) -> str:
    per = f"  = {r['ns_per_lane']:7.3f} ns/lane" if "ns_per_lane" in r else ""
    return f"[{r['device']}] n=2^{r['log2n']} {r['op']:36s} {r['ms']:9.3f} ms{per}"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log2n", type=int, default=20)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args()
    for row in measure(resolve_device(args.device), args.log2n):
        print(format_row(row), flush=True)


if __name__ == "__main__":
    main()
