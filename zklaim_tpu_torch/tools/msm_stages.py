"""Per-stage timing of the flat Pippenger pipeline on the current device.

Counterpart of tools/msm_stages.py.  The pipeline runs eagerly here, so the
stages are timed where they run: the spans msm.pippenger._window_partials
opens around each stage (digits; table and composite sort; packed gather
in bit-reversed order; upsweep tree; bucket-tail prefixes; Abel reduction)
and _finish around the finish, recorded with a synchronise at each span's
end (utils.profiling.recording(sync=device)).  One pass of the flat batch
is timed (n x 256 / c lanes, at most MAX_LANES), the least of `runs`
repeats a stage.

On the card, `upsweep_launches` then times that pass's upsweep on the
card's own clock (graph replay, utils.profiling.device_ms): the K4 loop it
replaced (point_add_halves a level) level by level and whole; each launch
of msm/upsweep_plan.py's plan and the whole plan; the plan with its first
launch taking r = 1 ... of the levels it can hold (the one depth the plan
chooses rather than derives: each variant's later launches are
narrow_launches); and a level's latency on an idle card, one launch of one
CTA taking the last r levels.

    python -m zklaim_tpu_torch.tools.msm_stages [--log2n N] [--c C] [--runs R] [--g2] [--device cpu]
"""

from __future__ import annotations

import argparse
import ctypes
import random

import numpy as np
import torch

from .. import resolve_device
from ..utils.profiling import card_label, device_ms, recording, sync

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
        sync(device)
        with recording(sync=device) as rec:
            tot, head = P._window_partials(deg, [(rows, scalars)], c)
            P._finish(deg, tot, head, c, 1)
        ms = {name: own / 1e6 for (_, _, name, _), own in zip(rec.spans, rec.self_ns())}
        best = {s: min(best[s], ms[f"msm.{s}"]) for s in STAGES}
    out, cum = [], 0.0
    for s in STAGES:
        cum += best[s]
        out.append({"probe": "msm_stages", "device": card_label(device), "deg": deg,
                    "log2n": log2n, "c": c, "stage": s, "ms": best[s], "cum_ms": cum})
    return out


def upsweep_launches(device, deg: int, nb: int, seed: int = 1) -> dict:
    """The upsweep of a pass of 2^nb lanes (level 0 as kernels/cases.py:
    pass_points draws it), device ms: the K4 loop by level and whole, the
    plan by launch and whole, its first-launch variants, a one-CTA launch of
    the last r levels.  Checks the plan's levels against the loop's."""
    from .. import kernels as K
    from ..ec import gpu_curve as G
    from ..kernels.cases import pass_points
    from ..msm import upsweep_plan as UP

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("upsweep_launches times kernels on a card")
    level0 = pass_points(deg, 1 << nb, np.random.default_rng(seed), device)
    loop = [level0]
    while loop[-1].shape[-1] > 1:
        loop.append(G.point_add_halves(deg, loop[-1]))

    def whole_loop():
        lv = level0
        while lv.shape[-1] > 1:
            lv = G.point_add_halves(deg, lv)

    plan = UP.upsweep_plan(deg, nb)
    levels = G.msm_upsweep_planes(deg, level0, plan)
    if not all(torch.equal(a, b) for a, b in zip(levels, loop)):
        raise AssertionError(f"G{deg}: msm_upsweep's levels differ from the K4 loop's")
    table = G._level_table(levels)

    def one(t, r, cols):
        K.launch("msm_upsweep", deg, ctypes.addressof(table), nb + 1, t, r, cols, device=device)

    cols = UP.THREADS // deg
    variants = {r: [(0, r, cols)] + UP.narrow_launches(deg, nb, r)
                for r in range(1, UP.held_levels(deg, cols) + 1)}
    return {"device": card_label(device), "deg": deg, "lanes": 1 << nb, "plan": plan,
            "k4_level_ms": [device_ms(lambda lv=lv: G.point_add_halves(deg, lv))
                            for lv in loop[:-1]],
            "k4_loop_ms": device_ms(whole_loop, calls=3),
            "launch_ms": [device_ms(lambda p=p: one(*p)) for p in plan],
            "plan_ms": device_ms(lambda: G.msm_upsweep_planes(deg, level0, plan), calls=3),
            "first_levels_ms": {r: [v, device_ms(lambda v=v: G.msm_upsweep_planes(
                deg, level0, v), calls=3)] for r, v in variants.items()},
            "one_cta_ms_by_levels": {r: device_ms(lambda r=r: one(nb - r, r, 1))
                                     for r in range(1, min(nb, UP.held_levels(deg, 1)) + 1)}}


def format_launches(u: dict) -> list:
    d = u["device"]
    return [f"[{d}] G{u['deg']} upsweep of {u['lanes']} lanes, device ms: K4 loop "
            f"{u['k4_loop_ms']:.4f} (levels " + " ".join(f"{v:.4f}" for v in u["k4_level_ms"]) + ")",
            f"[{d}]   plan {u['plan']}: {u['plan_ms']:.4f} (launches "
            + " ".join(f"{v:.4f}" for v in u["launch_ms"]) + ")",
            f"[{d}]   first launch of r levels: " + "; ".join(
                f"r={r} {plan} {ms:.4f}" for r, (plan, ms) in u["first_levels_ms"].items()),
            f"[{d}]   one CTA, the last r levels: "
            + " ".join(f"r={k} {v:.4f}" for k, v in u["one_cta_ms_by_levels"].items())]


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
    device = resolve_device(args.device)
    deg = 2 if args.g2 else 1
    rows = measure(device, args.log2n, args.c, args.runs, deg)
    print("\n".join(format_rows(rows)), flush=True)
    if device.type == "cuda":
        lanes = (1 << args.log2n) * (256 // args.c)
        print("\n".join(format_launches(upsweep_launches(device, deg, lanes.bit_length() - 1))))


if __name__ == "__main__":
    main()
