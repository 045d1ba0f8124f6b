"""Throughput of chained elementwise torch operations on one device.

Counterpart of tools/vpu_micro.py, which amplifies one XLA elementwise op
by a 512-step loop inside one program.  PyTorch runs eagerly: each step here
is its own kernel launch that reads and writes the whole array (2^20
elements, 4 MB each way), so these rows measure what a chain of eager
elementwise ops costs -- device-memory traffic and launches -- where the
probe K7 (tools.pallas_op_micro) measures the arithmetic itself with the
element held in a register.  torch has no uint32 arithmetic; the integer rows
use int32, whose multiply and add wrap to the same bit patterns.

    python -m zklaim_tpu_torch.tools.vpu_micro [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import resolve_device
from ..utils.profiling import best_ms, card_label

N = 1 << 20
REPS = 512


def measure(device, n: int = N, reps: int = REPS) -> list:
    device = torch.device(device)
    a32 = torch.from_numpy(np.random.default_rng(0).integers(1, 1 << 16, size=n,
                                                             dtype=np.int32)).to(device)
    af = a32.float()

    def loop(body, x):
        def run():
            v = x
            for i in range(reps):
                v = body(v, i)
            return v
        return run

    chains = [
        ("i32 mul", 1, loop(lambda v, i: v * (v | 1), a32)),
        ("i32 add", 1, loop(lambda v, i: v + (v ^ i), a32)),
        ("i32 shr+and", 2, loop(lambda v, i: (v >> 3) & 0xFFFF, a32)),
        ("f32 mul+add", 1, loop(lambda v, i: v * 1.0000001 + 0.5, af)),
        ("i32 mul lo16", 1, loop(lambda v, i: ((v & 0xFFFF) * 3) & 0x7FFFFFFF, a32)),
    ]
    rows = []
    for name, inner, fn in chains:
        ms = best_ms(fn, device)
        rows.append({"probe": "vpu_micro", "device": card_label(device), "chain": name,
                     "elements": n, "reps": reps, "ms": ms,
                     "ops_per_s": n * reps * inner / (ms * 1e-3)})
    return rows


def format_row(r: dict) -> str:
    return (f"[{r['device']}] {r['chain']:16s} {r['ms']:9.3f} ms  "
            f"{r['ops_per_s'] / 1e9:9.2f} Gops/s")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args()
    device = resolve_device(args.device)
    small = {} if device.type == "cuda" else {"n": 1 << 12, "reps": 8}
    for row in measure(device, **small):
        print(format_row(row), flush=True)


if __name__ == "__main__":
    main()
