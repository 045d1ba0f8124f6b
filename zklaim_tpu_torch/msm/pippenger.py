"""Multi-scalar multiplication (Pippenger) over BN254 G1/G2 in PyTorch.

Counterpart of zklaim_tpu/msm/pippenger.py, same algorithm (see that
module's docstring for the derivation):

  1. W = 256/c signed c-bit digits per scalar; all (window, point) pairs
     form ONE flat batch of M = W*N lanes, sorted once by the composite
     key w*(B+1) + |digit| (stable sort, as lax.sort_key_val is), carrying
     a pre-resolved row index into the table [P | -P | infinity];
  2. one row gather from the packed (n, 48 deg) table, stored in
     bit-reversed order so every upsweep level adds contiguous halves;
  3. global prefixes at the W*(B+1) bucket tails from the upsweep levels;
  4. per window, Abel summation B*F(t_B) - sum_{b<B} F(t_b) by a halving
     tree over the bucket-major grid;
  5. finish: (c-1) doublings of the window totals, then a Horner ladder.

msm_many runs k sums as one flat batch (window w of sum i is window
i*W + w) and one finish whose Horner ladder is k lanes wide: the finish's
~W*c sequential adds are paid once for all k sums, not k times.

The upsweep -- every level of the pass, column j of level t + 1 the sum of
columns j and j + w_t / 2 of level t -- is `_upsweep`: on CUDA planes a few
launches of kernel msm_upsweep (gpu_curve.msm_upsweep_planes; four a pass of
2^20 or 2^21 lanes, planned by msm/upsweep_plan.py), on CPU planes
`_upsweep_plain`, the loop of the plain add over the halves.  The Abel tree
-- the same halving of the heads down to the window columns -- is `_abel`:
on CUDA planes kernel msm_abel (gpu_curve.msm_abel_planes; one launch up to
c = 11 G1 and 10 G2, a chain of them past that), on CPU planes `_abel_plain`.  The kernels pair the columns as the loops do, so
every level matches the JAX package's loops limb for limb.  The bucket-tail
prefixes of step 3 -- for each of the W (B + 1) tail lanes, one add of an
upsweep node per set bit of its prefix length, lowest level first -- are
`_tails`: on CUDA planes ONE launch of kernel msm_tails
(gpu_curve.msm_tails_planes), on CPU planes `_tails_plain`, the loop of the
JAX package (a plain add and a select a level).  Skipping a level whose bit
is clear is the select's choice, so both give its planes limb for limb.
The finish -- (c - 1) doublings of the window
totals, then a Horner ladder of W*c doublings and W adds -- is `_finish`:
on CUDA planes ONE launch of kernel msm_finish
(gpu_curve.msm_finish_planes), on CPU planes `_finish_plain`, the loop over
the plain doubling and add.  Both have the JAX package's dataflow
(jaxcurve.point_double, then point_add), so where the flat pipeline runs
on both sides the finished point matches it projectively, limb for limb.

msm is the JAX package's dispatcher: N <= ZKLAIM_MSM_LADDER_MAX (default
512) goes to msm_ladder, a batched 256-step double-and-add and a halving
fold, larger N to the flat pipeline.  The prover calls msm_many / msm_pow2
directly, so every N of a proof runs the flat pipeline.
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import torch

from ..ec import curve as C
from ..ec.gpu_curve import (
    msm_abel_planes, msm_finish_planes, msm_tails_planes, msm_upsweep_planes, point_add_halves,
    point_add_plain, point_add_planes, point_double_plain, scalar_mul,
)
from ..ff import montgomery as M
from ..ff.limbs import LIMB_BITS, NUM_LIMBS
from ..ff.montgomery import FQ
from ..utils.profiling import count, span
from .upsweep_plan import abel_plan, upsweep_plan

# Max flat-batch lanes (k sums x W windows x points) per pass: the working
# set is that many gathered rows plus about the same again in upsweep levels.
MAX_LANES = {1: 1 << 21, 2: 1 << 20}


def signed_digits(scalars: torch.Tensor, c: int) -> torch.Tensor:
    """(N, 16) plain-domain int32 limbs -> (W, N) int32 signed digits.

    Digits lie in [-2^(c-1), 2^(c-1)]; windows are LSB-first.  Requires
    c | 16 and scalars < 2^254 (true for Fr), so the final carry is
    absorbed by the top window.
    """
    if LIMB_BITS % c:
        raise ValueError("window size must divide 16")
    per_limb = LIMB_BITS // c
    W = NUM_LIMBS * per_limb
    mask = (1 << c) - 1
    half = 1 << (c - 1)
    out = []
    carry = torch.zeros_like(scalars[:, 0])
    for w in range(W):
        d = ((scalars[:, w // per_limb] >> (c * (w % per_limb))) & mask) + carry
        ge = d > half
        carry = ge.to(d.dtype)
        out.append(torch.where(ge, d - (1 << c), d))
    return torch.stack(out).to(torch.int32)


@lru_cache(maxsize=None)
def _bitrev_np(k: int) -> np.ndarray:
    idx = np.arange(1 << k, dtype=np.int64)
    rev = np.zeros_like(idx)
    for b in range(k):
        rev |= ((idx >> b) & 1) << (k - 1 - b)
    return rev


def _revbits(idx: torch.Tensor, nb: int) -> torch.Tensor:
    """Bit-reverse (width nb) each element of an int64 vector."""
    r = torch.zeros_like(idx)
    for b in range(nb):
        r |= ((idx >> b) & 1) << (nb - 1 - b)
    return r


def _neg_rows(deg: int, rows: torch.Tensor) -> torch.Tensor:
    """Packed rows of -P: the y coordinate negated."""
    y = slice(16 * deg, 32 * deg)
    out = rows.clone()
    out[:, y] = M.neg_mod(FQ, rows[:, y].reshape(-1, NUM_LIMBS)).view(rows.shape[0], -1)
    return out


def infinity_rows(deg: int, n: int, device) -> torch.Tensor:
    return C.planes_to_rows(C.infinity_planes(deg, n, device))


def _window_partials(deg: int, tables: list, c: int):
    """Flat-batch bucket phase: per-window (F(t_B), sum_{b<B} F(t_b)).

    tables: k pairs (rows (n, 48 deg) packed projective points, scalars
    (n, 16) plain limbs), one n for all, k * W * n a power of two.  The k
    sums share one flat batch: window w of sum i is window i*W + w.
    Returns (tot_w, head_w), each (3 deg, 16, k*W) planes.  Both are
    group-linear in the points, so chunks may be summed before the finish.
    The pass is span msm.pass, its stages follow one another as spans
    msm.digits, msm.sort, msm.gather, msm.upsweep, msm.tails and msm.abel
    (tools.msm_stages times them).
    """
    with span("msm.pass"):
        k = len(tables)
        n = tables[0][0].shape[0]
        dev = tables[0][0].device
        with span("msm.digits"):
            digits = torch.cat([signed_digits(s, c) for _, s in tables]).long()   # (k W, n)
        KW = digits.shape[0]
        W = KW // k
        B = 1 << (c - 1)
        Mw = KW * n
        nb = Mw.bit_length() - 1
        if (1 << nb) != Mw:
            raise ValueError("flat batch k*W*N must be a power of two (pad N and k)")

        with span("msm.sort"):
            # table [P_0 .. P_k-1 | -P_0 .. -P_k-1 | infinity]; the gather index
            # pre-resolves the sum (row + i n), digit sign (+ k n), digit zero (2 k n)
            table = torch.cat([r for r, _ in tables] + [_neg_rows(deg, r) for r, _ in tables]
                              + [infinity_rows(deg, 1, dev)])
            mag = digits.abs()
            win = torch.arange(KW, device=dev)[:, None]
            keys = (win * (B + 1) + mag).reshape(-1)
            src = (win // W) * n + torch.arange(n, device=dev)
            idx = torch.where(mag == 0, 2 * k * n,
                              src + torch.where(digits < 0, k * n, 0)).reshape(-1)
            skeys, perm = torch.sort(keys, stable=True)
            sidx = idx[perm]

        with span("msm.gather"):
            # bit-reversed storage: every upsweep level pairs contiguous halves
            sidx_br = sidx[torch.from_numpy(_bitrev_np(nb)).to(dev)]
            level0 = C.rows_to_planes(table.index_select(0, sidx_br))
        with span("msm.upsweep"):
            levels = _upsweep(deg, level0)

        with span("msm.tails"):
            # global prefixes at every bucket tail: t_{w,b} = last sorted index
            # with key <= w*(B+1)+b; block j of level t lives at rev_{nb-t}(j)
            bucket_keys = (win * (B + 1) + torch.arange(B + 1, device=dev)).reshape(-1)
            m = torch.searchsorted(skeys, bucket_keys, right=True)   # prefix lengths
            acc = _tails(deg, levels, m, nb)

        with span("msm.abel"):
            # Abel summation per window (window-start corrections cancel):
            # B*F(t_{w,B}) - sum_{b<B} F(t_{w,b})
            grid = acc.view(3 * deg, NUM_LIMBS, KW, B + 1)
            tot_w = grid[..., B].contiguous()
            heads = grid[..., :B].transpose(2, 3).reshape(3 * deg, NUM_LIMBS, B * KW)
            heads = _abel(deg, heads, KW)                        # b-major, window-minor
        return tot_w, heads


def _add_halves_plain(deg: int, planes: torch.Tensor) -> torch.Tensor:
    """The plain add of the contiguous halves: (3 deg, 16, w) -> (3 deg, 16, w/2)."""
    w = planes.shape[-1]
    return point_add_plain(deg, planes[..., : w // 2], planes[..., w // 2 :])


def _upsweep_plain(deg: int, level0: torch.Tensor) -> list:
    """Plain version of kernel msm_upsweep, on any device: the levels of a
    flat batch of 2^nb lanes, level t + 1 the plain sum of level t's halves,
    down to width 1."""
    levels = [level0]
    while levels[-1].shape[-1] > 1:
        levels.append(_add_halves_plain(deg, levels[-1]))
    return levels


def _upsweep(deg: int, level0: torch.Tensor) -> list:
    """The upsweep levels: CUDA planes -> the launches of msm_upsweep that
    upsweep_plan gives, CPU planes -> _upsweep_plain."""
    if level0.is_cuda:
        nb = level0.shape[-1].bit_length() - 1
        return msm_upsweep_planes(deg, level0, upsweep_plan(deg, nb))
    return _upsweep_plain(deg, level0)


def _abel_plain(deg: int, heads: torch.Tensor, kw: int) -> torch.Tensor:
    """Plain version of kernel msm_abel, on any device: the heads halved
    down to kw columns."""
    while heads.shape[-1] > kw:
        heads = _add_halves_plain(deg, heads)
    return heads


def _abel(deg: int, heads: torch.Tensor, kw: int) -> torch.Tensor:
    """The Abel tree of a pass: CUDA planes -> the msm_abel launches of
    abel_plan (one up to c = 11 G1, 10 G2), CPU planes -> _abel_plain."""
    if heads.is_cuda:
        return msm_abel_planes(deg, heads, kw, abel_plan(deg, heads.shape[-1], kw))
    return _abel_plain(deg, heads, kw)


def _tail_nodes(m: torch.Tensor, nb: int, t: int) -> tuple:
    """(bit t of each prefix length, the column of upsweep level t the lane
    reads where it is set) for a flat batch of 2^nb lanes."""
    nat = ((m >> t) - 1).clamp(0, (1 << (nb - t)) - 1)
    store = _revbits(nat, nb - t) if nb - t > 0 else nat
    return ((m >> t) & 1) == 1, store


def _tails_plain(deg: int, levels: list, m: torch.Tensor, nb: int) -> torch.Tensor:
    """Plain version of kernel msm_tails, on any device: the prefix sum of
    each tail lane from the upsweep levels (level t: (3 deg, 16, 2^(nb-t))),
    one plain add a level whose bit of the lane's prefix length m is set."""
    acc = C.infinity_planes(deg, m.shape[0], m.device)
    for t, lvl in enumerate(levels):
        bit, store = _tail_nodes(m, nb, t)
        node = lvl.index_select(2, store)
        acc = torch.where(bit, point_add_plain(deg, acc, node), acc)
    return acc


def _tails(deg: int, levels: list, m: torch.Tensor, nb: int) -> torch.Tensor:
    """The bucket-tail prefixes: CUDA planes -> one msm_tails launch, CPU
    planes -> _tails_plain."""
    if m.is_cuda:
        return msm_tails_planes(deg, levels, m, nb)
    return _tails_plain(deg, levels, m, nb)


def _dbl_k(deg: int, p: torch.Tensor, k: int) -> torch.Tensor:
    """k complete doublings, each the plain version."""
    for _ in range(k):
        p = point_double_plain(deg, p)
    return p


def _neg_planes(deg: int, planes: torch.Tensor) -> torch.Tensor:
    out = planes.clone()
    y = slice(deg, 2 * deg)
    out[y] = M.neg_mod(FQ, planes[y].transpose(1, 2)).transpose(1, 2)
    return out


def _finish_plain(deg: int, tot: torch.Tensor, head: torch.Tensor, c: int, k: int) -> torch.Tensor:
    """Plain version of kernel msm_finish, on any device: (3 deg, 16, k W)
    partials of k sums -> (3 deg, 16, k): doublings, then one Horner ladder
    that runs the k sums side by side, every step a plain point op."""
    W = tot.shape[-1] // k
    window_pts = point_add_plain(deg, _dbl_k(deg, tot, c - 1), _neg_planes(deg, head))
    # (W, 3 deg, 16, k): window w of every sum, contiguous
    per_window = window_pts.view(3 * deg, NUM_LIMBS, k, W).permute(3, 0, 1, 2).contiguous()
    acc = C.infinity_planes(deg, k, tot.device)
    for w in range(W - 1, -1, -1):
        acc = point_add_plain(deg, _dbl_k(deg, acc, c), per_window[w])
    return acc


def _finish(deg: int, tot: torch.Tensor, head: torch.Tensor, c: int, k: int) -> torch.Tensor:
    """The finish of k sums (span msm.finish): CUDA planes -> one msm_finish
    launch, CPU planes -> _finish_plain."""
    with span("msm.finish"):
        if tot.is_cuda:
            return msm_finish_planes(deg, tot, head, c, k)
        return _finish_plain(deg, tot, head, c, k)


def _msm_chunked(deg: int, tables: list, c: int, chunk: int, k: int):
    """Bucket phase per fixed-size chunk of the point axis, window
    partials summed across chunks, ONE finish at the end."""
    n = tables[0][0].shape[0]
    tot = head = C.infinity_planes(deg, k * (256 // c), tables[0][0].device)
    for i in range(0, n, chunk):
        t, h = _window_partials(deg, [(r[i : i + chunk], s[i : i + chunk]) for r, s in tables], c)
        tot = point_add_planes(deg, tot, t)
        head = point_add_planes(deg, head, h)
    return _finish(deg, tot, head, c, k)


def padded_shape(deg: int, lengths: list, c: int = 8, chunk: int | None = None) -> tuple:
    """(k2, n2, chunk) of msm_many over sums of `lengths` points: k padded
    to k2, a power of two; every sum padded to n2 points, a power of two
    (at least 2) or, past `chunk` (default MAX_LANES / (k2 W)), a multiple
    of it."""
    k2 = 1 << (len(lengths) - 1).bit_length()
    n = max(lengths)
    chunk = chunk or max(1, MAX_LANES[deg] // (k2 * (256 // c)))
    n2 = max(2, 1 << (n - 1).bit_length())
    if n2 > chunk:
        n2 = -(-n // chunk) * chunk
    return k2, n2, chunk


def msm_many(deg: int, pairs: list, c: int = 8, chunk: int | None = None) -> torch.Tensor:
    """k sums sum_i scalars[i] * P_i at once -> (3 deg, 16, k) planes.

    pairs: k (rows, scalars) with rows (N_j, 48 deg) packed projective
    points (Montgomery form) and scalars (N_j, 16) plain-domain Fr limbs.
    The k sums run as one flat batch and one finish.  Each point axis is
    padded with infinity to a common power of two (the bit-reversed
    upsweep needs k*W*N = 2^K), k to a power of two with empty sums, and
    inputs above `chunk` points per sum (default MAX_LANES / (k W)) run
    in chunks (padded_shape).  The call is span msm.g1 or msm.g2; it
    counts the padded sums' points (msm.lanes) and the infinity rows among
    them (msm.padded_lanes)."""
    k = len(pairs)
    for rows, scalars in pairs:
        if scalars.shape != (rows.shape[0], NUM_LIMBS) or rows.shape[1] != 48 * deg:
            raise ValueError(f"msm: rows {tuple(rows.shape)} with scalars {tuple(scalars.shape)}")
    with span(f"msm.g{deg}"):
        lengths = [r.shape[0] for r, _ in pairs]
        k2, n2, chunk = padded_shape(deg, lengths, c, chunk)
        count("msm.lanes", k2 * n2)
        count("msm.padded_lanes", k2 * n2 - sum(lengths))
        dev = pairs[0][0].device
        empty = torch.zeros((0, NUM_LIMBS), dtype=torch.int32, device=dev)
        tables = []
        for rows, scalars in list(pairs) + [(infinity_rows(deg, 0, dev), empty)] * (k2 - k):
            pad = n2 - rows.shape[0]
            if pad:
                rows = torch.cat([rows, infinity_rows(deg, pad, dev)])
                scalars = torch.cat([scalars, scalars.new_zeros((pad, NUM_LIMBS))])
            tables.append((rows, scalars))
        if n2 <= chunk:
            out = _finish(deg, *_window_partials(deg, tables, c), c, k2)
        else:
            out = _msm_chunked(deg, tables, c, chunk, k2)
        return out[..., :k]


def msm_pow2(deg: int, rows: torch.Tensor, scalars: torch.Tensor, c: int = 8) -> torch.Tensor:
    """sum_i scalars[i] * P_i -> (3 deg, 16, 1) projective planes (msm_many
    with one sum)."""
    return msm_many(deg, [(rows, scalars)], c)


def _ladder_max() -> int:
    """Largest point count that msm routes to msm_ladder."""
    return int(os.environ.get("ZKLAIM_MSM_LADDER_MAX", "512"))


def msm_ladder(deg: int, rows: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """Small-N MSM -> (3 deg, 16, 1) planes: scalars[i] * P_i for all lanes
    at once (gpu_curve.scalar_mul), then a halving fold over the lanes,
    padded with infinity to a power of two.  Lane 0 of every level is the
    sum jaxcurve's rolled fold leaves there.  No size requirement; slower a
    point than the flat pipeline."""
    per = scalar_mul(deg, C.rows_to_planes(rows), scalars)
    n = per.shape[2]
    n2 = max(1, 1 << (n - 1).bit_length())
    if n2 != n:
        per = torch.cat([per, C.infinity_planes(deg, n2 - n, per.device)], dim=2)
    while per.shape[2] > 1:
        per = point_add_halves(deg, per)
    return per


def msm(deg: int, rows: torch.Tensor, scalars: torch.Tensor, c: int = 8) -> torch.Tensor:
    """Multi-scalar multiplication sum_i scalars[i] * P_i -> (3 deg, 16, 1)
    planes.  rows: (N, 48 deg) packed projective points; scalars: (N, 16)
    plain-domain Fr limbs.  N <= ZKLAIM_MSM_LADDER_MAX (default 512) uses
    the ladder, larger N the flat Pippenger pipeline (msm_pow2)."""
    if rows.shape[0] <= _ladder_max():
        return msm_ladder(deg, rows, scalars)
    return msm_pow2(deg, rows, scalars, c)
