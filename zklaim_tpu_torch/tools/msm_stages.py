"""Per-stage timing of the flat Pippenger pipeline on the current device.

Counterpart of tools/msm_stages.py.  The pipeline runs eagerly here, so the
stages are timed where they run: msm.pippenger._window_partials calls a mark
at the end of each stage (digits; table and composite sort; packed gather
in bit-reversed order; upsweep tree; bucket-tail prefixes; Abel reduction),
the finish follows, and every mark synchronises the device.  One pass of
the flat batch is timed (n x 256 / c lanes, at most MAX_LANES), the least
of `runs` repeats a stage.

    python -m zklaim_tpu_torch.tools.msm_stages [--log2n N] [--c C] [--runs R] [--g2] [--device cpu]
"""

from __future__ import annotations

import argparse
import random
import time

import torch

from .. import resolve_device
from ..utils.profiling import card_label, sync

STAGES = ("digits", "sort", "gather", "upsweep", "tails", "abel", "finish")


def measure(device, log2n: int = 16, c: int = 8, runs: int = 3, deg: int = 1,
            seed: int = 20260820) -> list:
    """One row per stage: its least milliseconds and the cumulative sum."""
    from ..bench import make_points
    from ..ff.limbs import ints_to_limbs, to_tensor
    from ..ff.params import R
    from ..msm import pippenger as P

    device = torch.device(device)
    n = 1 << log2n
    lanes = n * (256 // c)
    if lanes > P.MAX_LANES[deg]:
        raise ValueError(f"2^{log2n} points are {lanes} lanes, more than one pass of "
                         f"{P.MAX_LANES[deg]}: time one pass")
    rows = make_points(deg, n, device)
    rng = random.Random(seed)
    scalars = to_tensor(ints_to_limbs([rng.randrange(R) for _ in range(n)]), device)

    best = dict.fromkeys(STAGES, float("inf"))
    for _ in range(runs + 1):                               # the first is the warm-up
        times = {}
        sync(device)
        last = [time.perf_counter()]

        def mark(name):
            sync(device)
            now = time.perf_counter()
            times[name] = (now - last[0]) * 1e3
            last[0] = now

        tot, head = P._window_partials(deg, [(rows, scalars)], c, mark)
        P._finish(deg, tot, head, c, 1)
        mark("finish")
        best = {s: min(best[s], times[s]) for s in STAGES}
    out, cum = [], 0.0
    for s in STAGES:
        cum += best[s]
        out.append({"probe": "msm_stages", "device": card_label(device), "deg": deg,
                    "log2n": log2n, "c": c, "stage": s, "ms": best[s], "cum_ms": cum})
    return out


def format_rows(rows: list) -> list:
    r0 = rows[0]
    n = 1 << r0["log2n"]
    lines = [f"[{r0['device']}] G{r0['deg']} n=2^{r0['log2n']} c={r0['c']} "
             f"flat lanes={n * (256 // r0['c'])}"]
    lines += [f"[{r['device']}]   {('+' if i else '') + r['stage']:12s} cum {r['cum_ms']:9.3f} ms"
              f"   (+{r['ms']:8.3f} ms)" for i, r in enumerate(rows)]
    lines.append(f"[{r0['device']}]   throughput @FULL: {n / rows[-1]['cum_ms']:.1f}k pts/s")
    return lines


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log2n", type=int, default=16)
    ap.add_argument("--c", type=int, default=8)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--g2", action="store_true")
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args()
    rows = measure(resolve_device(args.device), args.log2n, args.c, args.runs,
                   2 if args.g2 else 1)
    print("\n".join(format_rows(rows)), flush=True)


if __name__ == "__main__":
    main()
