"""Instruction rate of single 32-bit operations on the card: kernel K7 (op_chain),
differenced over two chain lengths.

Counterpart of tools/pallas_op_micro.py.  K7 runs K chained elementwise
steps on a flat array, each element held in a register:

    u32add  v + (v ^ 12345)        u32mul  v * (v | 1)
    u16mul  (v & 0xFFFF) * 3       f32fma  fma(v, 1.0000001, 0.5)

and (elements x (K2 - K1)) / (t(K2) - t(K1)) is the rate of that step with
launch, load and store cancelled.  Measured at the original's shape, (16, 8192),
and at (16, WIDE_COLS) elements, which fills the card.  One thread's chain
is serial, so a rate is the card's only as far as the lanes in flight cover
the instruction's latency; the u32mul rate is the ceiling of every
Montgomery product here (csrc/field.cuh multiplies 32 x 32 bits).

Integer elements travel as int32 bit patterns (torch has no uint32
arithmetic on the CPU); the plain versions work in int64 masked to 32 bits
and are exact.  The plain f32fma takes each step in float64, where the
product of two float32 values and the sum with 0.5 are exact at these
magnitudes, and rounds once to float32: bit for bit the kernel's fused
multiply-add, so that op too is compared with tolerance 0.

    python -m zklaim_tpu_torch.tools.pallas_op_micro [--device cpu]

On the CPU the plain versions run at K = 2 and 6 by the host clock: a drive
of the control flow, and the row says "cpu".
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import kernels as K
from .. import resolve_device
from ..utils.profiling import best_ms, card_label

OPS = ("u32add", "u32mul", "u16mul", "f32fma")        # the original's order
OP_IDS = {"u32mul": 0, "u32add": 1, "u16mul": 2, "f32fma": 3}   # csrc/probes.cu
ROWS, COLS = 16, 8192
WIDE_COLS = 4 * 132 * 2048
CHAIN = (20000, 120000)
CHAIN_CPU = (2, 6)
FMA_A = float(np.float32(1.0000001))      # the float32 the kernel multiplies by
SEED = 0
_MASK = 0xFFFFFFFF


def _wrap_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 with the same bit pattern."""
    return ((v ^ 0x80000000) - 0x80000000).to(torch.int32)


def op_chain_plain(op: str, x: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version of K7 on any device: k steps of `op` on every element."""
    if op == "f32fma":
        v = x.clone()
        for _ in range(k):
            v = (v.double() * FMA_A + 0.5).float()    # exact in float64, one rounding
        return v
    v = x.long() & _MASK
    for _ in range(k):
        if op == "u32add":
            v = (v + (v ^ 12345)) & _MASK
        elif op == "u32mul":
            w = v | 1                             # v w mod 2^32 from 16-bit halves: no overflow
            v = ((v & 0xFFFF) * w + (((v >> 16) * (w & 0xFFFF)) << 16)) & _MASK
        elif op == "u16mul":
            v = (v & 0xFFFF) * 3
        else:
            raise ValueError(f"op_chain: unknown op {op!r}")
    return _wrap_i32(v)


def op_chain(op: str, x: torch.Tensor, k: int) -> torch.Tensor:
    """k chained steps of `op` on every element of x (int32 bit patterns of
    uint32 values; float32 for f32fma): one K7 launch on CUDA, the plain
    version on the CPU."""
    if op not in OP_IDS:
        raise ValueError(f"op_chain: unknown op {op!r}")
    want = torch.float32 if op == "f32fma" else torch.int32
    if x.dtype != want:
        raise ValueError(f"op_chain {op}: expected {want}, got {x.dtype}")
    if not x.is_cuda:
        return op_chain_plain(op, x, k)
    dev = K.launch_device("op_chain", others=(x,))
    if not x.is_contiguous() or k < 0:
        raise ValueError(f"op_chain: expected a contiguous tensor and k >= 0, got strides "
                         f"{x.stride()} k {k}")
    out = torch.empty_like(x)
    if x.numel():
        K.launch("op_chain", OP_IDS[op], x.data_ptr(), out.data_ptr(), x.numel(), k, device=dev)
    return out


def probe_input(op: str, cols: int, device, seed: int = SEED) -> torch.Tensor:
    """(16, cols) values in [1, 2^15), as the original draws them."""
    vals = np.random.default_rng(seed).integers(1, 1 << 15, size=(ROWS, min(cols, COLS)))
    vals = np.tile(vals, (1, -(-cols // vals.shape[1])))[:, :cols]
    dtype = np.float32 if op == "f32fma" else np.int32
    return torch.from_numpy(np.ascontiguousarray(vals.astype(dtype))).to(device)


def measure(device, widths=(COLS, WIDE_COLS)) -> list:
    """One row per (width, op): the differenced rate of one step."""
    device = torch.device(device)
    k1, k2 = CHAIN if device.type == "cuda" else CHAIN_CPU
    rows = []
    for cols in widths:
        for op in OPS:
            x = probe_input(op, cols, device)
            t1 = best_ms(lambda: op_chain(op, x, k1), device)
            t2 = best_ms(lambda: op_chain(op, x, k2), device)
            rows.append({
                "probe": "pallas_op_micro", "kernel": "op_chain", "device": card_label(device),
                "op": op, "elements": x.numel(), "k1": k1, "k2": k2, "t1_ms": t1, "t2_ms": t2,
                "ops_per_s": x.numel() * (k2 - k1) / ((t2 - t1) * 1e-3),
            })
    return rows


def format_row(r: dict) -> str:
    return (f"[{r['device']}] {r['op']:10s} elements={r['elements']:9d} t1={r['t1_ms']:9.3f}ms "
            f"t2={r['t2_ms']:9.3f}ms  delta-rate {r['ops_per_s'] / 1e9:10.1f} Gops/s")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args()
    device = resolve_device(args.device)
    widths = (COLS, WIDE_COLS) if device.type == "cuda" else (COLS,)
    for row in measure(device, widths):
        print(format_row(row), flush=True)


if __name__ == "__main__":
    main()
