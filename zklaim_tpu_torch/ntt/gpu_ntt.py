"""Radix-2 DIT butterfly stages on (16, n) Fr limb planes: kernels K2/K3.

Counterpart of zklaim_tpu/ntt/pallas_ntt.py.  The k = log2(n) stages of a
transform, on planes already in bit-reversed order, are two steps:

  - `ntt_local`: the stages with pair distance half < tile, one K2 launch:
    a tile on a thread-block cluster of CLUSTER CTAs (`local_split`), the
    stages that pair two CTAs through distributed shared memory;
  - `ntt_global`: the stages with half >= tile in passes of up to
    MAX_PASS_STAGES consecutive stages, one K3 launch a pass: those stages
    pair elements of one column (j mod tile) only, so a CTA holds C columns
    x the 2^G rows its pass pairs in shared memory (`global_passes` plans
    the passes and C).

`ntt_local_rows` is K2's other entry, the one a transform starts with: it
reads the (n, 16) AoS input in bit-reversed row order (`bitrev_rows`) and
writes new planes, in the same launch as the local stages.

A batch of B transforms of n is one plane of width B n, transform b in
segment b: no stage pairs elements of two segments, so every function here
takes the transform size `n` apart from the plane's width (default: one
transform) and runs the batch in the launches of one transform -- one K2,
one K3 a pass.  The rows entry then reads a (n, B, 16) input, element j of
transform b at row bitrev(j) B + b.

Twiddles come as one flat (16, n - 1) plane, stage s at offset 2^s - 1
(see NTTDomain.tw_flat).  On a CUDA tensor the wrappers launch the
kernels; on a CPU tensor `ntt_local` runs `ntt_plain`, the plain version,
on the same stages, `ntt_local_rows` the same after the bit-reversal
index_select and the transpose, and `ntt_global` runs
`ntt_global_columns_plain`, which walks the kernel's passes, CTAs and
twiddle indices.  `ntt_local_cluster_plain` walks K2's clusters the same
way.  `ntt_plain` is the oracle of both walks in the tests.
"""

from __future__ import annotations

import torch

from .. import kernels as K
from ..ff import montgomery as M
from ..ff.montgomery import FR

TILE = 1024        # K2 tile, a cluster of CTAs; K3's passes start at stage log2(TILE)
CLUSTER = 4        # K2: CTAs a tile, 256 elements and 128 threads each at TILE
MAX_CTA_LOG = 10   # K2: 2^10 elements a CTA at most, 512 threads (csrc/ntt.cu:zk_ntt_local)
MAX_PASS_STAGES = 6     # K3: stages a launch
PASS_ELEMENTS = 2048    # K3: 2^G C elements a CTA at most, 64 KiB (csrc/ntt.cu:NTT_PASS_SHARED_MAX)
PASS_COLUMNS = 32       # K3: columns a CTA at most (128 B of each limb row)
MIN_CTAS = 132          # K3: narrow the CTAs until there are this many (the H100's SMs)


def _log_tile(n: int, tile: int) -> int:
    return min(tile, n).bit_length() - 1


def ntt_plain(x: torch.Tensor, tw_flat: torch.Tensor, stages: range) -> torch.Tensor:
    """Plain version of K2/K3: butterfly stages `stages` on (16, n) planes.

    Stage s pairs j with j + 2^s (j mod 2^(s+1) < 2^s): t = tw[r] x[j+2^s],
    x[j] += t, x[j+2^s] = x[j] - t, r = j mod 2^s.  Returns new planes.  A
    stage below log2 m never pairs across a segment of m, so the same call
    runs the stages of B transforms of m in (16, B m) planes."""
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


def _check(x: torch.Tensor, tw_flat: torch.Tensor, n: int) -> torch.device:
    """The launch's device; raises unless x is contiguous (16, B n) planes of
    transforms of n = 2^k >= 2 and tw_flat n's (16, n - 1) twiddles."""
    dev = K.launch_device("ntt", x, tw_flat)
    width = x.shape[1]
    if (x.shape[0] != 16 or not x.is_contiguous() or n & (n - 1) or n < 2 or width % n
            or width == 0):
        raise ValueError(f"ntt: expected contiguous (16, B 2^k) planes of transforms of {n}, "
                         f"got {tuple(x.shape)}")
    if tw_flat.shape != (16, n - 1) or (n > 2 and tw_flat.stride(1) != 1):
        raise ValueError(f"ntt: twiddle plane must be (16, {n - 1}) with unit element stride, "
                         f"got {tuple(tw_flat.shape)} strides {tw_flat.stride()}")
    return dev


def local_split(n: int, tile: int = TILE, cluster: int = CLUSTER) -> tuple:
    """K2's split of a transform of n: (lt, lc, le) -- 2^lt elements a tile
    on a cluster of 2^lc CTAs of 2^le elements (2^(le - 1) threads) each.
    A CTA keeps at least 2 elements, so a tile below 2 cluster elements
    takes fewer CTAs."""
    if cluster < 1 or cluster & (cluster - 1) or cluster > 8:
        raise ValueError(f"ntt: a cluster of {cluster} CTAs (1, 2, 4 or 8)")
    lt = _log_tile(n, tile)
    lc = min(cluster.bit_length() - 1, max(lt - 1, 0))
    if lt - lc > MAX_CTA_LOG:
        raise ValueError(f"ntt: a CTA of 2^{lt - lc} elements (at most 2^{MAX_CTA_LOG})")
    return lt, lc, lt - lc


def local_launch(n: int, tile: int = TILE, cluster: int = CLUSTER, batch: int = 1) -> dict:
    """The launch K2 makes for `batch` transforms of n: cluster size, CTAs,
    threads a CTA and dynamic shared memory a CTA (csrc/ntt.cu:zk_ntt_local)."""
    lt, lc, le = local_split(n, tile, cluster)
    e = 1 << le
    return {"cluster": 1 << lc, "ctas": batch * n >> le, "threads": e // 2,
            "shared_bytes": (e + (e - 1) + lc * (e // 2)) * 8 * 4}


def bitrev_rows(n: int, device) -> torch.Tensor:
    """Row read for element j of a transform of n = 2^k: j's k bits
    reversed, as the kernel takes them (__brev(j) >> (32 - k))."""
    k = n.bit_length() - 1
    j = torch.arange(n, dtype=torch.int64, device=device)
    rev = torch.zeros_like(j)
    for b in range(32):
        rev |= ((j >> b) & 1) << (31 - b)
    return rev >> (32 - k)


def ntt_local_cluster_plain(x: torch.Tensor, tw_flat: torch.Tensor, tile: int = TILE,
                            cluster: int = CLUSTER, rows: bool = False,
                            n: int | None = None) -> torch.Tensor:
    """Plain version of K2 that walks the kernel's split (local_split) over
    B transforms of n: every CTA (rank = its index mod the cluster size)
    loads its elements -- where `rows`, element j of transform b is row
    bitrev(j) B + b of the (n, B, 16) or (n, 16) AoS input, else column
    b n + j of (16, B n) planes -- and stages its twiddles at the kernel's
    offsets; runs the stages within a CTA with the kernel's pair and twiddle
    indices, then the stages that pair CTAs r and r ^ 2^c, each thread's
    pair and twiddle as the kernel computes them.  Returns new (16, B n)
    planes.  n: the transform size (default: x's first axis where `rows`,
    else the plane's width)."""
    if rows:
        n = x.shape[0]
        width = x.numel() // 16
    else:
        width = x.shape[1]
        n = n or width
    lt, lc, le = local_split(n, tile, cluster)
    e, h = 1 << le, 1 << (le - 1)
    dev = x.device
    blk = torch.arange(width >> le, device=dev)[:, None]
    rank = blk & ((1 << lc) - 1)
    j = (blk << le) + torch.arange(e, device=dev)[None, :]               # (CTAs, E)
    if rows:
        row = bitrev_rows(n, dev)[j % n] * (width // n) + j // n
        sm = x.reshape(width, 16)[row]                                   # (CTAs, E, 16)
    else:
        sm = x.t()[j]
    tw = tw_flat.t()
    t = torch.arange(h, device=dev)
    cross_l, staged = [], [tw[: e - 1].expand(width >> le, e - 1, 16)]
    for c in range(lc):
        lo = rank & ~(1 << c)
        cross_l.append((((rank >> c) & 1) << (le - 1)) | t[None, :])     # (CTAs, H)
        r = ((lo & ((1 << c) - 1)) << le) + cross_l[c]
        staged.append(tw[(1 << (le + c)) - 1 + r])
    smt = torch.cat(staged, dim=1)                                       # (CTAs, TW, 16)
    for s in range(le):
        half = 1 << s
        r = t & (half - 1)
        e0 = ((t >> s) << (s + 1)) + r
        tb = M.mont_mul_plain(FR, sm[:, e0 + half], smt[:, half - 1 + r])
        a = sm[:, e0]
        sm[:, e0], sm[:, e0 + half] = M.add_mod(FR, a, tb), M.sub_mod(FR, a, tb)
    for c in range(lc):
        lo_blk = (blk & ~((1 << lc) - 1)) | (rank & ~(1 << c))            # (CTAs, 1)
        hi_blk = lo_blk | (1 << c)
        lo_blk, hi_blk = lo_blk.expand(-1, h), hi_blk.expand(-1, h)
        tb = M.mont_mul_plain(FR, sm[hi_blk, cross_l[c]], smt[:, e - 1 + c * h + t])
        a = sm[lo_blk, cross_l[c]]
        sm[lo_blk, cross_l[c]], sm[hi_blk, cross_l[c]] = M.add_mod(FR, a, tb), M.sub_mod(FR, a, tb)
    out = torch.empty((width, 16), dtype=x.dtype, device=dev)
    out[j] = sm
    return out.t().contiguous()


def ntt_local(x: torch.Tensor, tw_flat: torch.Tensor, tile: int = TILE,
              cluster: int = CLUSTER, n: int | None = None) -> torch.Tensor:
    """The stages with pair distance below `tile` on (16, B n) planes of B
    transforms of n (default: one) in bit-reversed order: one K2 launch in
    place on CUDA."""
    n = n or x.shape[1]
    if not x.is_cuda:
        return ntt_plain(x, tw_flat, range(_log_tile(n, tile)))
    dev = _check(x, tw_flat, n)
    lt, lc, _ = local_split(n, tile, cluster)
    K.launch("ntt_local", x.data_ptr(), x.data_ptr(), x.shape[1], n.bit_length() - 1,
             tw_flat.data_ptr(), tw_flat.stride(0), lt, lc, 0, device=dev)
    return x


def ntt_local_rows(x: torch.Tensor, tw_flat: torch.Tensor, tile: int = TILE,
                   cluster: int = CLUSTER, bitrev: torch.Tensor | None = None) -> torch.Tensor:
    """The first step of B transforms of n: (n, B, 16) AoS rows in natural
    order -- or (n, 16), one transform -- to new (16, B n) planes, transform
    b in segment b, after the bit reversal and the stages with pair distance
    below `tile`.  CUDA: one K2 launch that gathers the rows itself; CPU:
    the bit-reversal index_select (through `bitrev`, the domain's table,
    where given), the transpose and ntt_plain."""
    n = x.shape[0]
    if x.dim() not in (2, 3) or x.shape[-1] != 16 or n & (n - 1) or n < 2 or not x.numel():
        raise ValueError(f"ntt: expected (2^k, B, 16) or (2^k, 16) rows, got {tuple(x.shape)}")
    width = x.numel() // 16
    if not x.is_cuda:
        rev = bitrev_rows(n, x.device) if bitrev is None else bitrev
        planes = x.index_select(0, rev).reshape(n, -1, 16).permute(2, 1, 0).reshape(16, width)
        return ntt_plain(planes, tw_flat, range(_log_tile(n, tile)))
    dev = K.launch_device("ntt", x, tw_flat)
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("ntt: K2 reads 16-byte aligned rows")
    out = torch.empty((16, width), dtype=torch.int32, device=dev)
    _check(out, tw_flat, n)
    lt, lc, _ = local_split(n, tile, cluster)
    K.launch("ntt_local", x.data_ptr(), out.data_ptr(), width, n.bit_length() - 1,
             tw_flat.data_ptr(), tw_flat.stride(0), lt, lc, 1, device=dev)
    return out


def global_passes(n: int, tile: int = TILE, batch: int = 1) -> list:
    """The K3 launches of `batch` transforms of n: (s0, G, C) each, stages
    s0 .. s0 + G - 1 on CTAs of C columns.  The stages with half >= tile are
    cut into the fewest passes of at most MAX_PASS_STAGES, as even as they go
    (larger first); C is the widest power of two up to PASS_COLUMNS with
    2^G C <= PASS_ELEMENTS that still gives MIN_CTAS CTAs (batch n / (2^G
    C)), else 1."""
    lt = _log_tile(n, tile)
    stages = n.bit_length() - 1 - lt
    if stages <= 0:
        return []
    count = -(-stages // MAX_PASS_STAGES)
    sizes = [stages // count + (i < stages % count) for i in range(count)]
    passes, s0 = [], lt
    for g in sizes:
        c = min(PASS_COLUMNS, 1 << lt, PASS_ELEMENTS >> g)
        while c > 1 and batch * n // (c << g) < MIN_CTAS:
            c //= 2
        passes.append((s0, g, c))
        s0 += g
    return passes


def ntt_global_columns_plain(x: torch.Tensor, tw_flat: torch.Tensor, tile: int = TILE,
                             passes: list | None = None, n: int | None = None) -> torch.Tensor:
    """Plain version of K3 that walks the kernel's split over the (16, B n)
    planes of B transforms of n (default: one): for each pass (s0, G, C) --
    by default global_passes' -- every CTA gathers its C columns x 2^G rows
    with the kernel's index formulas, runs the G stages on them with the
    kernel's pair and twiddle indices, and scatters them back.  Returns new
    planes."""
    width = x.shape[1]
    n = n or width
    lt = _log_tile(n, tile)
    a = x.t().contiguous()
    tw = tw_flat.t()
    dev = x.device
    for s0, g, c in global_passes(n, tile, width // n) if passes is None else passes:
        lc, b0, elems = c.bit_length() - 1, s0 - lt, c << g
        blk = torch.arange(width // elems, device=dev)[:, None]
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


def ntt_global(x: torch.Tensor, tw_flat: torch.Tensor, tile: int = TILE,
               n: int | None = None) -> torch.Tensor:
    """The stages with pair distance >= `tile` of the B transforms of n
    (default: one) in (16, B n) planes: one K3 a pass over the whole batch,
    in place on CUDA."""
    width = x.shape[1]
    n = n or width
    if not x.is_cuda:
        return ntt_global_columns_plain(x, tw_flat, tile, n=n)
    dev = _check(x, tw_flat, n)
    lt = _log_tile(n, tile)
    for s0, g, c in global_passes(n, tile, width // n):
        K.launch("ntt_stage", x.data_ptr(), width, n.bit_length() - 1, tw_flat.data_ptr(),
                 tw_flat.stride(0), lt, s0, g, c.bit_length() - 1, device=dev)
    return x

