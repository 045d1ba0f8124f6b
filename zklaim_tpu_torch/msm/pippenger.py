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

Each step is a stage of msm.gpu_msm, which states the pass's data formats
and runs a stage as its kernel on CUDA tensors, its plain version on CPU
tensors.

msm is the JAX package's dispatcher: N <= ZKLAIM_MSM_LADDER_MAX (default
512) goes to msm_ladder, a batched 256-step double-and-add and a halving
fold, larger N to the flat pipeline.  The prover calls msm_many / msm_pow2
directly, so every N of a proof runs the flat pipeline.
"""

from __future__ import annotations

import os

import torch

from ..ec import curve as C
from ..ec.gpu_curve import point_add_halves, point_add_planes, scalar_mul
from ..ff.limbs import LIMB_BITS, NUM_LIMBS
from ..utils.profiling import count, span
from .gpu_msm import abel, digit_keys, finish, infinity_rows, signed_gather, tails, upsweep

# Max flat-batch lanes (k sums x W windows x points) per pass: the working
# set is that many gathered rows plus about the same again in upsweep levels.
MAX_LANES = {1: 1 << 21, 2: 1 << 20}


def _window_partials(deg: int, tables: list, c: int):
    """Flat-batch bucket phase: per-window (F(t_B), sum_{b<B} F(t_b)).

    tables: k pairs (rows (n, 48 deg) packed projective points, scalars
    (n, 16) plain limbs), one n for all, k * W * n a power of two.  The k
    sums share one flat batch: window w of sum i is window i*W + w.
    Returns (tot_w, head_w), each (3 deg, 16, k*W) planes.  Both are
    group-linear in the points, so chunks may be summed before the finish.
    The pass is span msm.pass, its stages follow one another as spans
    msm.digits, msm.sort, msm.gather, msm.upsweep, msm.tails and msm.abel
    (tools.msm_stages times them).  Nothing in the pass waits for the card.
    """
    with span("msm.pass"):
        k = len(tables)
        n = tables[0][0].shape[0]
        if LIMB_BITS % c:
            raise ValueError("window size must divide 16")
        KW = k * (256 // c)
        B = 1 << (c - 1)
        nb = (KW * n).bit_length() - 1
        if (1 << nb) != KW * n:
            raise ValueError("flat batch k*W*N must be a power of two (pad N and k)")

        with span("msm.digits"):
            keys, idx = digit_keys([s for _, s in tables], c)
        with span("msm.sort"):
            skeys, perm = torch.sort(keys, stable=True)
        with span("msm.gather"):
            level0 = signed_gather(deg, [r for r, _ in tables], idx, perm, nb)
        with span("msm.upsweep"):
            levels = upsweep(deg, level0)

        with span("msm.tails"):
            # global prefixes at every bucket tail: t_{w,b} = last sorted index
            # with key <= w*(B+1)+b, and those keys are 0 ... KW*(B+1) - 1;
            # block j of level t lives at rev_{nb-t}(j)
            bucket_keys = torch.arange(KW * (B + 1), dtype=skeys.dtype, device=skeys.device)
            m = torch.searchsorted(skeys, bucket_keys, right=True)   # prefix lengths
            acc = tails(deg, levels, m, nb)

        with span("msm.abel"):
            # Abel summation per window (window-start corrections cancel):
            # B*F(t_{w,B}) - sum_{b<B} F(t_{w,b})
            grid = acc.view(3 * deg, NUM_LIMBS, KW, B + 1)
            tot_w = grid[..., B].contiguous()
            heads = grid[..., :B].transpose(2, 3).reshape(3 * deg, NUM_LIMBS, B * KW)
            heads = abel(deg, heads, KW)                        # b-major, window-minor
        return tot_w, heads


def _msm_chunked(deg: int, tables: list, c: int, chunk: int):
    """Bucket phase per fixed-size chunk of the point axis, window
    partials summed across chunks (one finish follows)."""
    n = tables[0][0].shape[0]
    tot = head = C.infinity_planes(deg, len(tables) * (256 // c), tables[0][0].device)
    for i in range(0, n, chunk):
        t, h = _window_partials(deg, [(r[i : i + chunk], s[i : i + chunk]) for r, s in tables], c)
        tot = point_add_planes(deg, tot, t)
        head = point_add_planes(deg, head, h)
    return tot, head


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
    in chunks (padded_shape).  The call is span msm.g1 or msm.g2, its
    finish span msm.finish; it counts the padded sums' points (msm.lanes)
    and the infinity rows among them (msm.padded_lanes)."""
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
            tot, head = _window_partials(deg, tables, c)
        else:
            tot, head = _msm_chunked(deg, tables, c, chunk)
        with span("msm.finish"):
            return finish(deg, tot, head, c, k2)[..., :k]


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
