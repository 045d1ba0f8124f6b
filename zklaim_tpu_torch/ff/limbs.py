"""Multi-limb big-integer representation for the PyTorch port.

Layout (identical to zklaim_tpu.ff.limbs): little-endian base-2^16 limbs
on a trailing axis of length NUM_LIMBS (16) => 256 bits per element.

Host side: numpy helpers, exact for arbitrary ints, returning uint32
arrays exactly as the JAX package does.

Device side: torch tensors hold the limbs as int32 (every value < 2^16).
Arithmetic widens to int64 inside a function: a 16x16-bit product reaches
2^32 - 2^17 + 1, which would wrap in int32 (and turn `>> 16` into an
arithmetic shift).  Carry chains are plain sequential 16-step ripples;
the JAX package's Kogge-Stone form only existed to keep XLA graphs small.
"""

from __future__ import annotations

import numpy as np
import torch

from .params import LIMB_BITS, LIMB_MASK, NUM_LIMBS

__all__ = [
    "LIMB_BITS", "LIMB_MASK", "NUM_LIMBS", "int_to_limbs", "ints_to_limbs",
    "limbs_to_int", "limbs_to_ints", "to_tensor",
    "carry_canonical", "sub_borrow", "select",
]


# ---------------------------------------------------------------------------
# Host <-> limb conversion (numpy; exact for arbitrary ints)
# ---------------------------------------------------------------------------


def int_to_limbs(x: int, n: int = NUM_LIMBS) -> np.ndarray:
    """Single int -> (n,) uint32 limb array (little-endian base 2^16)."""
    out = np.empty(n, dtype=np.uint32)
    for i in range(n):
        out[i] = x & LIMB_MASK
        x >>= LIMB_BITS
    if x:
        raise ValueError("integer does not fit in limb array")
    return out


def ints_to_limbs(xs, n: int = NUM_LIMBS) -> np.ndarray:
    """Iterable of ints -> (len, n) uint32 limb array."""
    xs = list(xs)
    try:
        buf = b"".join(x.to_bytes(2 * n, "little") for x in xs)
    except OverflowError as e:
        raise ValueError("integer does not fit in limb array") from e
    return np.frombuffer(buf, dtype="<u2").reshape(len(xs), n).astype(np.uint32)


def limbs_to_int(a) -> int:
    """(n,) limb array -> int."""
    a = np.asarray(a, dtype=np.uint64)
    x = 0
    for i in range(a.shape[-1] - 1, -1, -1):
        x = (x << LIMB_BITS) | int(a[i])
    return x


def limbs_to_ints(a) -> list:
    """(..., n) limb array -> flat list of ints."""
    a = np.asarray(a)
    return [limbs_to_int(row) for row in a.reshape(-1, a.shape[-1])]


def to_tensor(arr, device) -> torch.Tensor:
    """Host limb array (any integer dtype, values < 2^31) -> int32 tensor."""
    return torch.from_numpy(np.ascontiguousarray(arr, dtype=np.int32)).to(device)


# ---------------------------------------------------------------------------
# Raw limb helpers on int64 tensors, batched over leading axes
# ---------------------------------------------------------------------------


def carry_canonical(a: torch.Tensor, dim: int = -1):
    """Exact carry propagation along the limb axis `dim` (default: last).

    a: int64 lazy limbs, each in [0, 2^47).  Returns (canonical int64
    limbs < 2^16, carry_out) with value(a) = value(canonical) +
    carry_out * 2^(16n).  dim=0 on limb-major tensors keeps every step
    on a contiguous row.
    """
    outs = []
    carry = 0
    for col in a.unbind(dim):
        v = col + carry
        outs.append(v & LIMB_MASK)
        carry = v >> LIMB_BITS
    return torch.stack(outs, dim=dim), carry


def sub_borrow(a: torch.Tensor, b: torch.Tensor, dim: int = -1):
    """a - b over canonical int64 limbs -> (canonical limbs, borrow).

    borrow drops the limb axis and is in {0, 1}; the result encodes
    a - b + borrow * 2^(16n).
    """
    a, b = torch.broadcast_tensors(a, b)
    outs = []
    borrow = 0
    for ca, cb in zip(a.unbind(dim), b.unbind(dim)):
        t = ca - cb - borrow                  # in [-2^16, 2^16)
        outs.append(t & LIMB_MASK)            # two's complement: exact mod 2^16
        borrow = -(t >> LIMB_BITS)            # arithmetic shift: -1 -> 1, 0 -> 0
    return torch.stack(outs, dim=dim), borrow


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Broadcast select over the trailing limb axis: mask (...,), a/b (..., n)."""
    return torch.where(mask[..., None], a, b)
