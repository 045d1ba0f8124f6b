"""One G1 point add three ways, at 2^15 and 2^17 lanes.

Counterpart of tools/pallas_micro.py (the XLA add against the Pallas add):
  - the add as plain torch ops on AoS tuples (curve.point_add: its products
    go to kernel K1 in stacked batches, its additions are torch built-ins);
  - kernel K4 behind an AoS interface (planes built and taken apart);
  - kernel K4 on planes, the layout the MSM keeps.

    python -m zklaim_tpu_torch.tools.pallas_micro [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import resolve_device
from ..utils.profiling import best_ms, card_label


def measure(device, log2ns=(15, 17)) -> list:
    from ..ec import curve as C
    from ..ec.gpu_curve import point_add_planes
    from ..kernels.cases import random_points

    device = torch.device(device)
    f = C.FQ_OPS
    rows = []
    for log2n in log2ns:
        n = 1 << log2n
        base = random_points(1, min(n, 1 << 14), np.random.default_rng(log2n), device)
        planes = base.repeat(1, 1, n // base.shape[2]).contiguous()
        aos = C.planes_to_point(f, planes)
        for name, fn in [
            ("torch ops point_add, AoS", lambda: C.point_add(f, aos, aos)),
            ("K4 point_add, AoS in/out",
             lambda: C.planes_to_point(f, point_add_planes(1, C.point_to_planes(f, aos),
                                                           C.point_to_planes(f, aos)))),
            ("K4 point_add, planes", lambda: point_add_planes(1, planes, planes)),
        ]:
            ms = best_ms(fn, device)
            rows.append({"probe": "pallas_micro", "device": card_label(device), "log2n": log2n,
                         "variant": name, "ms": ms, "ns_per_lane": ms * 1e6 / n})
    return rows


def format_row(r: dict) -> str:
    return (f"[{r['device']}] {r['variant']:28s} (2^{r['log2n']},) {r['ms']:9.3f} ms "
            f"= {r['ns_per_lane']:8.3f} ns/lane")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args()
    device = resolve_device(args.device)
    for row in measure(device, (15, 17) if device.type == "cuda" else (3,)):
        print(format_row(row), flush=True)


if __name__ == "__main__":
    main()
