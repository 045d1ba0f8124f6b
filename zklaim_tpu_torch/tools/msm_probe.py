"""MSM timing probe on one device: points/s of `msm` over sizes and window
widths, with an optional check against the closed form.

Counterpart of tools/msm_probe.py.  Point i is ((i mod 2^14) + 1) G
(bench.make_points), so the sum is (sum_i s_i ((i mod 2^14) + 1)) G, which
`--check` holds the result to.  Each sample ends in a synchronise (CUDA
events on the card).

    python -m zklaim_tpu_torch.tools.msm_probe [--log2n 12 16] [--c 8 16] [--g2] [--check] [--device cpu]
"""

from __future__ import annotations

import argparse
import random

import torch

from .. import resolve_device
from ..utils.profiling import best_ms, card_label

SEED = 20260819


def measure(device, log2ns=(12, 16), cs=(8, 16), deg: int = 1, runs: int = 3,
            check: bool = False) -> list:
    """One row per (size, window width)."""
    from ..bench import make_points
    from ..ec import curve as C
    from ..ec.hostcurve import g1_generator, g2_generator
    from ..ff.limbs import ints_to_limbs, to_tensor
    from ..ff.params import R
    from ..msm.pippenger import msm

    device = torch.device(device)
    rows = []
    for log2n in log2ns:
        n = 1 << log2n
        points = make_points(deg, n, device)
        rng = random.Random(SEED)
        scalars_int = [rng.randrange(R) for _ in range(n)]
        scalars = to_tensor(ints_to_limbs(scalars_int), device)
        for c in cs:
            ms = best_ms(lambda: msm(deg, points, scalars, c), device, runs)
            row = {"probe": "msm_probe", "device": card_label(device), "deg": deg,
                   "log2n": log2n, "c": c, "ms": ms, "points_per_s": n / (ms * 1e-3)}
            if check:
                gen = g1_generator() if deg == 1 else g2_generator()
                total = sum(s * (i % (1 << 14) + 1) for i, s in enumerate(scalars_int)) % R
                got = C.planes_to_host_points(deg, msm(deg, points, scalars, c))[0]
                row["correct"] = got == gen * total
            rows.append(row)
    return rows


def format_row(r: dict) -> str:
    tail = f"  correct = {r['correct']}" if "correct" in r else ""
    return (f"[{r['device']}] g{r['deg']} n=2^{r['log2n']} c={r['c']}: best {r['ms']:.2f} ms  ->  "
            f"{r['points_per_s']:,.0f} points/s{tail}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log2n", type=int, nargs="+", default=[12, 16])
    ap.add_argument("--c", type=int, nargs="+", default=[8, 16])
    ap.add_argument("--g2", action="store_true")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args()
    for row in measure(resolve_device(args.device), args.log2n, args.c, 2 if args.g2 else 1,
                       args.runs, args.check):
        print(format_row(row), flush=True)


if __name__ == "__main__":
    main()
