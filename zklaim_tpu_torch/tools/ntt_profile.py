"""The number-theoretic transform on the card, step by step.

For each size n = 2^k, a row for each of
  - K2 on (16, n) planes in place (gpu_ntt.ntt_local: the stages with pair
    distance below the tile, no copy of its input);
  - K3 (gpu_ntt.ntt_global: the stages above the tile, its passes);
  - the transform's entry as the plain path makes it: the bit-reversal
    index_select of the (n, 16) rows and the transpose to planes (on the
    card, K2's gather entry does both in its own load);
  - the exit transpose of the planes back to rows;
  - a whole forward transform (NTTDomain.ntt) and a whole inverse (intt, with
    its n^{-1} scaling: one K1 launch);
  - with --clusters, K2 on planes again at each cluster size given (a tile
    of gpu_ntt.TILE on 1, 2, 4 or 8 CTAs): the split's own measurement.
Each row has its call time (least of 3 runs of `calls` calls, each ending
in a synchronise: the host's time between launches included) and, on the
card, the card's own time (utils.profiling.device_ms: the replay of a CUDA
graph of captured calls).  On the CPU the device time is not measured.

    python -m zklaim_tpu_torch.tools.ntt_profile [--log2n 15 22] [--clusters 1 2 4 8] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import resolve_device
from ..utils.profiling import best_ms, card_label, device_ms

STEPS = ("K2 ntt_local (planes, in place)", "K3 ntt_global", "entry: bitrev index_select + transpose",
         "exit transpose", "NTTDomain.ntt", "NTTDomain.intt")


def measure(device, log2ns=(15, 22), calls: int = 10, seed: int = 7, clusters=()) -> list:
    """One row per size and step: dicts with log2n, step, call_ms, device_ms."""
    from ..ntt import gpu_ntt
    from ..ntt.radix2 import get_domain

    device = torch.device(device)
    rows = []
    for k in log2ns:
        n = 1 << k
        dom = get_domain(n, str(device))
        limbs = np.random.default_rng(seed + k).integers(0, 1 << 16, size=(n, 16))
        limbs[:, 15] %= 0x3064                                  # below r
        x = torch.from_numpy(limbs.astype(np.int32)).to(device)
        planes = x.t().contiguous()
        steps = {
            STEPS[0]: lambda: gpu_ntt.ntt_local(planes, dom.tw_flat),
            STEPS[1]: lambda: gpu_ntt.ntt_global(planes, dom.tw_flat),
            STEPS[2]: lambda: x.index_select(0, dom.bitrev).t().contiguous(),
            STEPS[3]: lambda: planes.t().contiguous(),
            STEPS[4]: lambda: dom.ntt(x),
            STEPS[5]: lambda: dom.intt(x),
        }
        for c in clusters:
            steps[f"K2 ntt_local (planes, cluster of {c})"] = (
                lambda c=c: gpu_ntt.ntt_local(planes, dom.tw_flat, cluster=c))
        for step, fn in steps.items():
            call = best_ms(lambda fn=fn: [fn() for _ in range(calls)], device) / calls
            dev = device_ms(fn, calls) if device.type == "cuda" else None
            rows.append({"device": card_label(device), "log2n": k, "step": step,
                         "call_ms": call, "device_ms": dev})
    return rows


def format_rows(rows: list) -> list:
    return [f"[{r['device']}] ntt 2^{r['log2n']:<3d} {r['step']:40s} call {r['call_ms']:9.4f} ms  "
            + ("device not measured" if r["device_ms"] is None else f"device {r['device_ms']:.4f} ms")
            for r in rows]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log2n", type=int, nargs="+", default=[15, 22])
    ap.add_argument("--clusters", type=int, nargs="*", default=[],
                    help="also time K2 at these cluster sizes")
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args()
    rows = measure(resolve_device(args.device), tuple(args.log2n), clusters=tuple(args.clusters))
    print("\n".join(format_rows(rows)), flush=True)


if __name__ == "__main__":
    main()
