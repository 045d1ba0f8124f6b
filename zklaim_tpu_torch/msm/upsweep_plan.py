"""Launch plans of kernels msm_upsweep and msm_abel (csrc/curve.cu), and
their interpreters on the CPU.

A pass's upsweep builds levels 1 ... nb of a flat batch of 2^nb lanes from
level 0: column j of level t + 1 is column j + column j + w_t / 2 of level t
(w_t = 2^(nb - t)), the loop msm.gpu_msm.upsweep_plain runs.  Unrolled
over r levels, column j of level t + r is a tree over the 2^r columns
j + i w_{t+r} of level t, i < 2^r, and every node of that tree lies in the
same residue class mod w_{t+r}.  So a launch that computes levels
t + 1 ... t + r can give each CTA T neighbouring columns of level t + r:
the CTA reads its 2^r T inputs as 2^r runs of T neighbouring columns,
keeps the 2^(r-1) T points of level t + 1 in shared memory (and each level
after it in the first slots of the same memory: slot x of local level s
is slot x + slot x + 2^(r-s) T of local level s - 1) and writes every level's
columns to device memory, where kernel msm_tails reads them.

The plan (`upsweep_plan`) takes as many levels a launch as a CTA's shared
memory holds, `slots(deg)` points (48 KB: 512 G1 or 256 G2 points, 96 B a
G1 and 192 B a G2 point).  The first launch, which holds 7/8 of the adds,
gives a CTA one column a lane (T = THREADS / deg: 128 G1, 64 G2 columns),
so no lane waits at a barrier for another's work, and 3 levels, the most
its CTA holds (on the card 1 or 2 levels came out no faster;
tools/msm_stages times all three).  Every later launch, on levels
narrower than the card, takes runs of one column a lane of a warp (T =
WARP / deg: 32 G1, 16 G2 columns), so that a warp's loads of one limb are
one 128-byte line of each plane it reads, and more levels (5).
Once the levels left fit one CTA (2^(a-1) <= slots for a levels to go),
one launch of one CTA (T = 1) takes them all down to width 1.  A G1 pass of
2^21 lanes runs 4 launches (3 + 5 + 5 + 8 levels), a G2 pass of 2^20 4 (3 +
5 + 5 + 7).  (The kernel gives a launch of fewer CTAs than the card has
SMs CTAs of 384 threads, so its lanes take fewer turns at its first
levels; that is a matter of the launcher, not of the plan.)

The Abel tree of a pass halves the (3 deg, 16, B KW) heads down to KW
columns (B = 2^(c-1): c - 1 levels) in the same pairing, one CTA a window
column (T = 1), the inner levels in shared memory and only a launch's last
level stored (`abel_plan`).  A column's tree fits one CTA up to 2^10 heads
G1 and 2^9 G2 (c = 11 and 10); a taller tree (c = 16: 2^15 heads a column)
runs as a chain of such launches, each launch's columns the next one's
heads, its levels split as evenly as the launches allow.

`interpret_upsweep` and `interpret_abel` run a plan launch by launch and
CTA by CTA with the kernel's index arithmetic (the columns a slot stands
for, the slots a local level reads and writes) and the plain add, so the
CPU tests hold that arithmetic to the loops.
"""

from __future__ import annotations

import torch

from ..ec.gpu_curve import point_add_plain

THREADS = 128                 # csrc/curve.cu:UPS_THREADS, threads a CTA of a wide launch
SHARED_BYTES = 48 * 1024      # csrc/curve.cu:UPS_SHARED_MAX, shared memory a CTA
WARP = 32                     # threads a warp: a narrow launch gives each lane of one warp a column
POINT_BYTES = 3 * 8 * 4       # a G1 point in shared memory: 3 components of 8 32-bit words


def slots(deg: int) -> int:
    """Points a CTA keeps in shared memory: 512 (G1), 256 (G2)."""
    return SHARED_BYTES // (POINT_BYTES * deg)


def held_levels(deg: int, cols: int) -> int:
    """The most levels r a launch of `cols` columns a CTA takes: 2^(r-1) cols
    <= slots(deg)."""
    return (slots(deg) // cols).bit_length()


def upsweep_plan(deg: int, nb: int) -> list:
    """[(t, r, T)]: the launches that build levels 1 ... nb of a flat batch of
    2^nb lanes, launch i computing levels t + 1 ... t + r with T columns of
    level t + r a CTA (2^(nb-t-r) / T CTAs, 2^(r-1) T points of shared memory
    each): the first at one column a lane of a CTA, then narrow_launches."""
    if nb and 1 << (nb - 1) > slots(deg):
        cols = min(THREADS // deg, slots(deg))
        r = held_levels(deg, cols)
        return [(0, r, cols)] + narrow_launches(deg, nb, r)
    return narrow_launches(deg, nb, 0)


def narrow_launches(deg: int, nb: int, t: int) -> list:
    """The launches of levels t + 1 ... nb: runs of a warp's columns (T =
    WARP / deg) until the levels left fit one CTA, then that CTA (T = 1)."""
    plan = []
    while t < nb:
        a = nb - t
        if 1 << (a - 1) <= slots(deg):        # the rest fits one CTA
            return plan + [(t, a, 1)]
        cols = min(WARP // deg, slots(deg))
        r = held_levels(deg, cols)
        plan.append((t, r, cols))
        t += r
    return plan


def abel_plan(deg: int, width: int, kw: int) -> list:
    """[r]: the launches of the Abel tree, `width` heads to kw columns in R =
    log2(width / kw) levels, one CTA a column (T = 1); launch i halves its
    heads r_i times.  One launch where a column's tree fits a CTA (2^(R-1)
    <= slots(deg)), else the fewest launches that fit, their levels as even
    as they go (the larger first)."""
    if width % kw or (width // kw) & (width // kw - 1):
        raise ValueError(f"msm_abel: {width} heads do not halve to {kw} columns")
    levels = (width // kw).bit_length() - 1
    most = held_levels(deg, 1)
    n = -(-levels // most)
    return [levels // n + (i < levels % n) for i in range(n)]


def column(b: int, x: torch.Tensor, cols: int, w_out: int) -> torch.Tensor:
    """The column of level t + s that slot x of CTA b stands for, in a launch
    whose last level is w_out wide, T = cols columns a CTA (csrc/curve.cu:
    ups_col)."""
    return b * cols + x % cols + (x // cols) * w_out


def _interpret_launch(deg: int, src: torch.Tensor, r: int, cols: int, put) -> None:
    """One launch on `src` (level t), CTA by CTA: local level s = 1 reads its
    slots' columns of src, levels s > 1 read slots x and x + nout of the
    CTA's shared memory; each level's outputs go to shared memory (s < r) and
    to put(s, columns, points)."""
    w_out = src.shape[-1] >> r
    ns = (1 << (r - 1)) * cols
    for b in range(w_out // cols):
        smem = torch.empty((3 * deg, 16, ns), dtype=src.dtype)
        for s in range(1, r + 1):
            nout = (1 << (r - s)) * cols
            x = torch.arange(nout)
            if s == 1:
                a = src.index_select(2, column(b, x, cols, w_out))
                q = src.index_select(2, column(b, x + nout, cols, w_out))
            else:
                a, q = smem[..., :nout], smem[..., nout : 2 * nout]
            out = point_add_plain(deg, a, q)
            if s < r:
                smem[..., :nout] = out
            put(s, column(b, x, cols, w_out), out)


def interpret_upsweep(deg: int, level0: torch.Tensor, plan: list) -> list:
    """Levels 0 ... nb as kernel msm_upsweep builds them under `plan`, on CPU
    planes; a column no launch writes stays -1."""
    nb = level0.shape[-1].bit_length() - 1
    levels = [level0] + [torch.full((3 * deg, 16, 1 << (nb - t)), -1, dtype=level0.dtype)
                         for t in range(1, nb + 1)]
    for t, r, cols in plan:
        def put(s, idx, pts, t=t):
            levels[t + s][..., idx] = pts
        _interpret_launch(deg, levels[t], r, cols, put)
    return levels


def interpret_abel(deg: int, heads: torch.Tensor, kw: int) -> torch.Tensor:
    """The Abel tree as kernel msm_abel computes it under abel_plan, launch
    by launch and one CTA a column: only a launch's last level leaves the
    CTA, and it is the next launch's heads."""
    out = heads.clone()
    for r in abel_plan(deg, heads.shape[-1], kw):
        last = torch.full((3 * deg, 16, out.shape[-1] >> r), -1, dtype=heads.dtype)

        def put(s, idx, pts, r=r, last=last):
            if s == r:
                last[..., idx] = pts
        _interpret_launch(deg, out, r, 1, put)
        out = last
    return out
