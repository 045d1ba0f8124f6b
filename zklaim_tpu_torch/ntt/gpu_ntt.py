"""Radix-2 DIT butterfly stages on (16, n) Fr limb planes: kernels K2/K3.

Counterpart of zklaim_tpu/ntt/pallas_ntt.py.  The input is already in
bit-reversed order; `ntt_stages` runs all k = log2(n) stages in place:

  - `ntt_local`: the stages with pair distance half < tile, one K2 launch
    (one CTA per tile held in shared memory);
  - `ntt_global`: the stages with half >= tile in passes of up to
    MAX_PASS_STAGES consecutive stages, one K3 launch a pass: those stages
    pair elements of one column (j mod tile) only, so a CTA holds C columns
    x the 2^G rows its pass pairs in shared memory (`global_passes` plans
    the passes and C).

Twiddles come as one flat (16, n - 1) plane, stage s at offset 2^s - 1
(see NTTDomain.tw_flat).  On a CUDA tensor the wrappers launch the
kernels; on a CPU tensor `ntt_local` runs `ntt_plain`, the plain version,
on the same stages, and `ntt_global` runs `ntt_global_columns_plain`, which
walks the kernel's passes, CTAs and twiddle indices; `ntt_plain` is its
oracle in the tests.
"""

from __future__ import annotations

import torch

from .. import kernels as K
from ..ff import montgomery as M
from ..ff.montgomery import FR

TILE = 1024        # K2 tile: 1024 x 32 B = 32 KiB of shared memory per CTA
MAX_PASS_STAGES = 6     # K3: stages a launch
PASS_ELEMENTS = 2048    # K3: 2^G C elements a CTA at most, 64 KiB (csrc/ntt.cu:NTT_PASS_SHARED_MAX)
PASS_COLUMNS = 32       # K3: columns a CTA at most (128 B of each limb row)
MIN_CTAS = 132          # K3: narrow the CTAs until there are this many (the H100's SMs)


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


def global_passes(n: int, tile: int = TILE) -> list:
    """The K3 launches of a transform of n: (s0, G, C) each, stages s0 ..
    s0 + G - 1 on CTAs of C columns.  The stages with half >= tile are cut
    into the fewest passes of at most MAX_PASS_STAGES, as even as they go
    (larger first); C is the widest power of two up to PASS_COLUMNS with
    2^G C <= PASS_ELEMENTS that still gives MIN_CTAS CTAs (n / (2^G C)),
    else 1."""
    lt = _log_tile(n, tile)
    stages = n.bit_length() - 1 - lt
    if stages <= 0:
        return []
    count = -(-stages // MAX_PASS_STAGES)
    sizes = [stages // count + (i < stages % count) for i in range(count)]
    passes, s0 = [], lt
    for g in sizes:
        c = min(PASS_COLUMNS, 1 << lt, PASS_ELEMENTS >> g)
        while c > 1 and n // (c << g) < MIN_CTAS:
            c //= 2
        passes.append((s0, g, c))
        s0 += g
    return passes


def ntt_global_columns_plain(x: torch.Tensor, tw_flat: torch.Tensor, tile: int = TILE,
                             passes: list | None = None) -> torch.Tensor:
    """Plain version of K3 that walks the kernel's split: for each pass
    (s0, G, C) -- by default global_passes' -- every CTA gathers its C
    columns x 2^G rows with the kernel's index formulas, runs the G stages on
    them with the kernel's pair and twiddle indices, and scatters them back.
    Returns new planes."""
    n = x.shape[1]
    lt = _log_tile(n, tile)
    a = x.t().contiguous()
    tw = tw_flat.t()
    dev = x.device
    for s0, g, c in global_passes(n, tile) if passes is None else passes:
        lc, b0, elems = c.bit_length() - 1, s0 - lt, c << g
        blk = torch.arange(n // elems, device=dev)[:, None]
        c0 = (blk & ((1 << (lt - lc)) - 1)) << lc                    # first column of the CTA
        rest = blk >> (lt - lc)
        lo, hi = rest & ((1 << b0) - 1), rest >> b0
        e = torch.arange(elems, device=dev)[None, :]
        j = (((((hi << g) + (e >> lc)) << b0) + lo) << lt) + c0 + (e & (c - 1))
        sm = a[j]                                                    # (CTAs, 2^G C, 16)
        t = torch.arange(elems // 2, device=dev)
        cc, q = t & (c - 1), t >> lc
        for u in range(g):
            low = q & ((1 << u) - 1)
            e0 = (((((q >> u) << (u + 1)) + low) << lc) + cc)
            e1 = e0 + (c << u)
            r = (((low[None, :] << b0) + lo) << lt) + c0 + cc[None, :]
            tb = M.mont_mul_plain(FR, sm[:, e1], tw[(1 << (s0 + u)) - 1 + r])
            lo_v = sm[:, e0]
            sm[:, e0], sm[:, e1] = M.add_mod(FR, lo_v, tb), M.sub_mod(FR, lo_v, tb)
        a[j] = sm
    return a.t().contiguous()


def ntt_global(x: torch.Tensor, tw_flat: torch.Tensor, tile: int = TILE) -> torch.Tensor:
    """The stages with pair distance >= `tile`: one K3 a pass, in place on
    CUDA."""
    if not x.is_cuda:
        return ntt_global_columns_plain(x, tw_flat, tile)
    _check(x, tw_flat)
    n = x.shape[1]
    lt = _log_tile(n, tile)
    for s0, g, c in global_passes(n, tile):
        K.launch("ntt_stage", x.data_ptr(), n, tw_flat.data_ptr(), tw_flat.stride(0), lt, s0, g,
                 c.bit_length() - 1)
    return x


def ntt_stages(x: torch.Tensor, tw_flat: torch.Tensor, tile: int = TILE) -> torch.Tensor:
    """Every butterfly stage on (16, n) bit-reversed planes (n = 1: none)."""
    if x.shape[1] == 1:
        return x
    return ntt_global(ntt_local(x, tw_flat, tile), tw_flat, tile)
