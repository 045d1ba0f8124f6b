"""Radix-2 DIT butterfly stages on (16, n) Fr limb planes: kernels K2/K3.

Counterpart of zklaim_tpu/ntt/pallas_ntt.py.  The input is already in
bit-reversed order; `ntt_stages` runs all k = log2(n) stages in place:

  - `ntt_local`: the stages with pair distance half < tile, one K2 launch
    (one CTA per tile held in shared memory);
  - `ntt_global`: each stage with half >= tile, one K3 launch per stage
    (one thread per butterfly pair).

Twiddles come as one flat (16, n - 1) plane, stage s at offset 2^s - 1
(see NTTDomain.tw_flat).  On a CUDA tensor the wrappers launch the
kernels; on a CPU tensor they run `ntt_plain`, the plain version, on the
same split of stages.
"""

from __future__ import annotations

import torch

from .. import kernels as K
from ..ff import montgomery as M
from ..ff.montgomery import FR

TILE = 1024        # K2 tile: 1024 x 32 B = 32 KiB of shared memory per CTA


def _log_tile(n: int, tile: int) -> int:
    return min(tile, n).bit_length() - 1


def ntt_plain(x: torch.Tensor, tw_flat: torch.Tensor, stages: range) -> torch.Tensor:
    """Plain version of K2/K3: butterfly stages `stages` on (16, n) planes.

    Stage s pairs j with j + 2^s (j mod 2^(s+1) < 2^s): t = tw[r] x[j+2^s],
    x[j] += t, x[j+2^s] = x[j] - t, r = j mod 2^s.  Returns new planes."""
    n = x.shape[1]
    a = x.t().contiguous()
    tw = tw_flat.t()
    for s in stages:
        half = 1 << s
        v = a.view(n // (2 * half), 2, half, 16)
        lo, hi = v[:, 0], v[:, 1]
        t = M.mont_mul_plain(FR, hi, tw[half - 1 : 2 * half - 1])
        a = torch.stack([M.add_mod(FR, lo, t), M.sub_mod(FR, lo, t)], dim=1).view(n, 16)
    return a.t().contiguous()


def _check(x: torch.Tensor, tw_flat: torch.Tensor) -> None:
    K.check_planes(x, "ntt x")
    K.check_planes(tw_flat, "ntt twiddles")
    n = x.shape[1]
    if x.shape[0] != 16 or not x.is_contiguous() or n & (n - 1) or n < 2:
        raise ValueError(f"ntt: expected contiguous (16, 2^k) planes, got {tuple(x.shape)}")
    if tw_flat.shape != (16, n - 1) or tw_flat.stride(1) != 1:
        raise ValueError(f"ntt: twiddle plane must be (16, {n - 1}), got {tuple(tw_flat.shape)}")


def ntt_local(x: torch.Tensor, tw_flat: torch.Tensor, tile: int = TILE) -> torch.Tensor:
    """The stages with pair distance below `tile`: K2 in place on CUDA."""
    lt = _log_tile(x.shape[1], tile)
    if not x.is_cuda:
        return ntt_plain(x, tw_flat, range(lt))
    _check(x, tw_flat)
    K.launch("ntt_local", x.data_ptr(), x.shape[1], tw_flat.data_ptr(), tw_flat.stride(0), lt, lt)
    return x


def ntt_global(x: torch.Tensor, tw_flat: torch.Tensor, tile: int = TILE) -> torch.Tensor:
    """The stages with pair distance >= `tile`: one K3 each, in place on CUDA."""
    n = x.shape[1]
    stages = range(_log_tile(n, tile), n.bit_length() - 1)
    if not x.is_cuda:
        return ntt_plain(x, tw_flat, stages)
    _check(x, tw_flat)
    for s in stages:
        K.launch("ntt_stage", x.data_ptr(), n, tw_flat.data_ptr(), tw_flat.stride(0), s)
    return x


def ntt_stages(x: torch.Tensor, tw_flat: torch.Tensor, tile: int = TILE) -> torch.Tensor:
    """Every butterfly stage on (16, n) bit-reversed planes (n = 1: none)."""
    if x.shape[1] == 1:
        return x
    return ntt_global(ntt_local(x, tw_flat, tile), tw_flat, tile)
