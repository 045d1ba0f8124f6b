"""The stages of a Pippenger pass and its finish, each a kernel wrapper
beside its plain version: kernels msm_digits and msm_gather (csrc/msm.cu),
msm_upsweep, msm_tails and msm_abel (K4's other entries) and msm_finish
(K5's), csrc/curve.cu.

A pass runs k sums of n points at window size c (W = 256 / c windows, B =
2^(c-1)) as one flat batch of 2^nb = k W n lanes; window w of sum i is
window i W + w.  Its data, stage by stage:

  - digits: W signed digits a scalar in [-B, B], windows LSB first
    (signed_digits);
  - keys and index: lane (i W + w) n + j is window w of scalar j of sum i,
    of digit d; its sort key is (i W + w) (B + 1) + |d|, its index into the
    table [P_0 .. P_k-1 | -P_0 .. -P_k-1 | infinity] of the sums' packed
    rows i n + j for d > 0, k n + i n + j for d < 0 and 2 k n for d = 0;
  - level 0: the lanes stably sorted by key (permutation perm) and
    gathered bit-reversed into (3 deg, 16, 2^nb) planes, lane q the point of
    sorted lane rev_nb(q);
  - levels: level t (3 deg, 16, 2^(nb-t)), column j the sum of columns j
    and j + 2^(nb-t) of level t - 1, so every level adds contiguous halves
    and column j of level t is the block rev_(nb-t)(j) of 2^t sorted lanes;
  - tails: one lane a key (i W + w) (B + 1) + b, k W (B + 1) lanes, each
    the sum of the m sorted lanes of key at most its own: for each set bit
    t of m, lowest first, the column rev_(nb-t)((m >> t) - 1) of level t;
  - heads and partials: the tails as a (k W, B + 1) grid.  Column B is each
    window's total tot; columns b < B, b-major and window-minor (B k W
    lanes), halved c - 1 times down to k W columns, are head.  tot and
    head, (3 deg, 16, k W) each, are group-linear in the points, so the
    chunks of a sum may be added before the finish;
  - the finish: sum i = sum_w 2^(c w) (2^(c-1) tot - head)[i W + w], as
    c - 1 doublings of tot, -head added, and a Horner ladder from the top
    window (c doublings and one add a window), the k sums side by side.

    stage     dispatcher      plain version         wrapper (kernel)
    digits    digit_keys      digit_keys_plain      msm_digit_keys (msm_digits)
    gather    signed_gather   signed_gather_plain   msm_gather_planes (msm_gather)
    upsweep   upsweep         upsweep_plain         msm_upsweep_planes (msm_upsweep)
    tails     tails           tails_plain           msm_tails_planes (msm_tails)
    Abel      abel            abel_plain            msm_abel_planes (msm_abel)
    finish    finish          finish_plain          msm_finish_planes (msm_finish)

A plain version runs on any device with the plain point ops of
ec.gpu_curve, the JAX package's dataflow.  A wrapper checks its operands
and launches on CUDA tensors, and raises on CPU ones.  A dispatcher sends
CUDA tensors to the wrapper and CPU tensors to the plain version, so no
test on the card compares the plain version with itself.  The kernels pair
columns and add as the plain loops do: each stage gives its plain
version's planes limb for limb.  The upsweep's and the Abel tree's launches
are planned by msm/upsweep_plan.py.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels as K
from ..ec import curve as C
from ..ec import rcb_schedule
from ..ec.gpu_curve import check_points, point_add_plain, point_double_plain
from ..ff import montgomery as M
from ..ff.limbs import LIMB_BITS, NUM_LIMBS
from ..utils.device_cache import device_constant
from .upsweep_plan import abel_plan, upsweep_plan

FRONT_MAX_SUMS = 64                  # csrc/msm.cu:FRONT_MAX_SUMS
TAILS_MAX_LEVELS = 32                # csrc/curve.cu:TAIL_MAX_LEVELS
FINISH_SHARED_BYTES = 227 * 1024     # what a CTA can opt in to (csrc/curve.cu:FIN_SHARED_MAX)
FINISH_MAX_WARPS = 16                # csrc/curve.cu:FIN_THREADS / 32


def _revbits(idx: torch.Tensor, nb: int) -> torch.Tensor:
    """Bit-reverse (width nb) each element of an int64 vector."""
    r = torch.zeros_like(idx)
    for b in range(nb):
        r |= ((idx >> b) & 1) << (nb - 1 - b)
    return r


def infinity_rows(deg: int, n: int, device) -> torch.Tensor:
    return C.planes_to_rows(C.infinity_planes(deg, n, device))


def _sum_tables(tensors: list, width: int, what: str):
    """The k tables of a pass's sums, (n, width) int32, contiguous and
    16-byte aligned (the kernels read them as 16-byte vectors), one n for
    all -> (n, their base pointers as the C launchers read them)."""
    if not 1 <= len(tensors) <= FRONT_MAX_SUMS:
        raise ValueError(f"{what}: {len(tensors)} sums (1 to {FRONT_MAX_SUMS})")
    n = tensors[0].shape[0] if tensors[0].dim() == 2 else -1
    for i, t in enumerate(tensors):
        K.check_planes(t, f"{what} {i}")
        if t.dim() != 2 or t.shape != (n, width) or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what} {i}: expected a contiguous, 16-byte aligned ({n}, {width}) "
                             f"table, got shape {tuple(t.shape)} strides {t.stride()}")
    if n < 1:
        raise ValueError(f"{what}: sums of {n} points")
    return n, (ctypes.c_longlong * len(tensors))(*[t.data_ptr() for t in tensors])


def _level_table(levels: list):
    """(base, plane stride, limb stride) a level, as the C launchers read
    them: a by-value table copied into the launch."""
    words = [v for lvl in levels for v in (lvl.data_ptr(), lvl.stride(0), lvl.stride(1))]
    return (ctypes.c_longlong * len(words))(*words)


@device_constant
def _schedule_on(build, deg: int, device: str) -> tuple:
    """(the packed schedule build(deg) on the device, its group size, its
    slot count), uploaded once."""
    sched = build(deg)
    words = torch.from_numpy(rcb_schedule.pack(sched).view("int32").copy())   # the same bits
    return words.to(device), sched["g"], sched["slots"]


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


def digit_keys_plain(scalars: list, c: int) -> tuple:
    """Plain version of kernel msm_digits, on any device: k (n, 16) scalar
    tables -> (keys, idx), each (k W n,) int32."""
    k, n, dev = len(scalars), scalars[0].shape[0], scalars[0].device
    digits = torch.cat([signed_digits(s, c) for s in scalars]).long()   # (k W, n)
    KW = digits.shape[0]
    W, B = KW // k, 1 << (c - 1)
    mag = digits.abs()
    win = torch.arange(KW, device=dev)[:, None]
    keys = (win * (B + 1) + mag).reshape(-1)
    src = (win // W) * n + torch.arange(n, device=dev)
    idx = torch.where(mag == 0, 2 * k * n, src + torch.where(digits < 0, k * n, 0)).reshape(-1)
    return keys.int(), idx.int()


def msm_digit_keys(scalars: list, c: int) -> tuple:
    """A pass's digits in one launch of kernel msm_digits: k (n, 16)
    plain-domain scalar tables -> (keys, idx), each (k W n,) int32, limb
    for limb what digit_keys_plain gives.  CUDA tensors only."""
    n, table = _sum_tables(scalars, NUM_LIMBS, "msm_digits scalars")
    dev = K.launch_device("msm_digits", *scalars)
    if c < 1 or LIMB_BITS % c:
        raise ValueError(f"msm_digits: window size {c} does not divide {LIMB_BITS}")
    k, W, B = len(scalars), 256 // c, 1 << (c - 1)
    if k * W * (B + 1) > 1 << 31 or 2 * k * n >= 1 << 31:
        raise ValueError(f"msm_digits: {k} sums of {n} points at c = {c} overflow int32 keys")
    keys = torch.empty(k * W * n, dtype=torch.int32, device=dev)
    idx = torch.empty_like(keys)
    K.launch("msm_digits", ctypes.addressof(table), k, n, c, keys.data_ptr(), idx.data_ptr(),
             device=dev)
    return keys, idx


def digit_keys(scalars: list, c: int) -> tuple:
    """A pass's sort keys and gather index: CUDA scalars -> one msm_digits
    launch, CPU scalars -> digit_keys_plain."""
    if scalars[0].is_cuda:
        return msm_digit_keys(scalars, c)
    return digit_keys_plain(scalars, c)


def _neg_rows(deg: int, rows: torch.Tensor) -> torch.Tensor:
    """Packed rows of -P: the y coordinate negated."""
    y = slice(16 * deg, 32 * deg)
    out = rows.clone()
    out[:, y] = M.neg_mod(M.FQ, rows[:, y].reshape(-1, NUM_LIMBS)).view(rows.shape[0], -1)
    return out


def signed_gather_plain(deg: int, rows: list, idx: torch.Tensor, perm: torch.Tensor,
                        nb: int) -> torch.Tensor:
    """Plain version of kernel msm_gather, on any device: the table [P | -P
    | infinity] of the k sums' rows, the sorted index idx[perm] in
    bit-reversed order, one row gather -> level 0."""
    dev = idx.device
    table = torch.cat(rows + [_neg_rows(deg, r) for r in rows] + [infinity_rows(deg, 1, dev)])
    sidx = idx.long()[perm]
    sidx_br = sidx[_revbits(torch.arange(1 << nb, device=dev), nb)]
    return C.rows_to_planes(table.index_select(0, sidx_br))


@device_constant
def _infinity_row_on(deg: int, device: str) -> torch.Tensor:
    """The packed infinity row on the device, made once."""
    return infinity_rows(deg, 1, device).reshape(-1)


def msm_gather_planes(deg: int, rows: list, idx: torch.Tensor, perm: torch.Tensor,
                      nb: int) -> torch.Tensor:
    """Level 0 of a pass in one launch of kernel msm_gather: k (n, 48 deg)
    packed point tables, the gather index idx (2^nb,) int32 of
    msm_digit_keys and the stable sort's permutation perm (2^nb,) int64 ->
    (3 deg, 16, 2^nb) planes, limb for limb what signed_gather_plain gives.
    The index is trusted: it must come from msm_digit_keys over the same k
    and n.  CUDA tensors only."""
    n, table = _sum_tables(rows, 48 * deg, f"msm_gather G{deg} rows")
    if not 0 <= nb <= 31 or 2 * len(rows) * n >= 1 << 31:
        raise ValueError(f"msm_gather: 2^{nb} lanes over {len(rows)} sums of {n} points")
    for name, t, dtype in (("idx", idx, torch.int32), ("perm", perm, torch.int64)):
        if t.dtype != dtype or t.shape != (1 << nb,) or not t.is_contiguous():
            raise ValueError(f"msm_gather: {name} must be a contiguous (2^{nb},) {dtype} "
                             f"vector, got {t.dtype} {tuple(t.shape)}")
    dev = K.launch_device("msm_gather", *rows, idx, others=(perm,))
    inf = _infinity_row_on(deg, str(dev))
    out = torch.empty((3 * deg, 16, 1 << nb), dtype=torch.int32, device=dev)
    K.launch("msm_gather", deg, ctypes.addressof(table), len(rows), n, idx.data_ptr(),
             perm.data_ptr(), nb, inf.data_ptr(), out.data_ptr(), device=dev)
    return out


def signed_gather(deg: int, rows: list, idx: torch.Tensor, perm: torch.Tensor,
                  nb: int) -> torch.Tensor:
    """Level 0 of a pass: CUDA tensors -> one msm_gather launch, CPU tensors
    -> signed_gather_plain."""
    if idx.is_cuda:
        return msm_gather_planes(deg, rows, idx, perm, nb)
    return signed_gather_plain(deg, rows, idx, perm, nb)


def _add_halves_plain(deg: int, planes: torch.Tensor) -> torch.Tensor:
    """The plain add of the contiguous halves: (3 deg, 16, w) -> (3 deg, 16, w/2)."""
    w = planes.shape[-1]
    return point_add_plain(deg, planes[..., : w // 2], planes[..., w // 2 :])


def upsweep_plain(deg: int, level0: torch.Tensor) -> list:
    """Plain version of kernel msm_upsweep, on any device: level 0 and
    every level after it, each the plain sum of the last one's halves."""
    levels = [level0]
    while levels[-1].shape[-1] > 1:
        levels.append(_add_halves_plain(deg, levels[-1]))
    return levels


def msm_upsweep_planes(deg: int, level0: torch.Tensor, plan: list) -> list:
    """Every upsweep level of a flat batch of 2^nb lanes: level0 (3 deg, 16,
    2^nb) planes -> [level0, level 1, ..., level nb], limb for limb what
    upsweep_plain gives.  Levels 1 ... nb are views into one buffer (the
    tails read them by their strides).  One msm_upsweep launch a (t, r, T)
    of `plan` (upsweep_plan.upsweep_plan), which must cover levels 1 ... nb
    in order.  CUDA tensors only."""
    check_points(deg, level0, "msm_upsweep level 0")
    dev = K.launch_device("msm_upsweep", level0)
    n = level0.shape[2]
    nb = n.bit_length() - 1
    if n != 1 << nb or nb >= TAILS_MAX_LEVELS:
        raise ValueError(f"msm_upsweep: {n} lanes (a power of two below 2^{TAILS_MAX_LEVELS})")
    if [t for t, _, _ in plan] != [sum(r for _, r, _ in plan[:i]) for i in range(len(plan))] \
            or sum(r for _, r, _ in plan) != nb:
        raise ValueError(f"msm_upsweep: plan {plan} does not build levels 1 ... {nb} in order")
    buf = torch.empty((3 * deg, 16, max(n - 1, 1)), dtype=torch.int32, device=dev)
    levels, off = [level0], 0
    for t in range(1, nb + 1):
        levels.append(buf[..., off : off + (n >> t)])
        off += n >> t
    table = _level_table(levels)
    for t, r, cols in plan:
        K.launch("msm_upsweep", deg, ctypes.addressof(table), nb + 1, t, r, cols, device=dev)
    return levels


def upsweep(deg: int, level0: torch.Tensor) -> list:
    """The upsweep levels: CUDA planes -> the launches of msm_upsweep that
    upsweep_plan gives, CPU planes -> upsweep_plain."""
    if level0.is_cuda:
        nb = level0.shape[-1].bit_length() - 1
        return msm_upsweep_planes(deg, level0, upsweep_plan(deg, nb))
    return upsweep_plain(deg, level0)


def _tail_nodes(m: torch.Tensor, nb: int, t: int) -> tuple:
    """(bit t of each prefix length, the column of upsweep level t the lane
    reads where it is set) for a flat batch of 2^nb lanes."""
    nat = ((m >> t) - 1).clamp(0, (1 << (nb - t)) - 1)
    store = _revbits(nat, nb - t) if nb - t > 0 else nat
    return ((m >> t) & 1) == 1, store


def tails_plain(deg: int, levels: list, m: torch.Tensor, nb: int) -> torch.Tensor:
    """Plain version of kernel msm_tails, on any device: the prefix sum of
    each tail lane from the upsweep levels, one plain add and a select a
    level (the JAX package's loop; a clear bit's add is not kept)."""
    acc = C.infinity_planes(deg, m.shape[0], m.device)
    for t, lvl in enumerate(levels):
        bit, store = _tail_nodes(m, nb, t)
        node = lvl.index_select(2, store)
        acc = torch.where(bit, point_add_plain(deg, acc, node), acc)
    return acc


def msm_tails_planes(deg: int, levels: list, m: torch.Tensor, nb: int) -> torch.Tensor:
    """The bucket-tail prefixes of a flat batch of 2^nb lanes in one launch
    of kernel msm_tails.  levels: the nb + 1 upsweep levels (any plane and
    row strides); m: (L,) int64 prefix lengths.  -> (3 deg, 16, L) planes,
    limb for limb what tails_plain gives.  CUDA tensors only."""
    if m.dtype != torch.int64 or m.dim() != 1 or not m.is_contiguous():
        raise ValueError(f"msm_tails: m must be a contiguous (L,) int64 vector, got "
                         f"{m.dtype} {tuple(m.shape)}")
    if not 0 <= nb < TAILS_MAX_LEVELS or len(levels) != nb + 1:
        raise ValueError(f"msm_tails: {len(levels)} levels for a batch of 2^{nb} lanes "
                         f"(nb + 1 levels, at most {TAILS_MAX_LEVELS})")
    for t, lvl in enumerate(levels):
        check_points(deg, lvl, f"msm_tails level {t}")
        if lvl.shape[2] != 1 << (nb - t):
            raise ValueError(f"msm_tails: level {t} is {tuple(lvl.shape)}, "
                             f"expected width {1 << (nb - t)}")
    dev = K.launch_device("msm_tails", *levels, others=(m,))
    sched, g, slots = _schedule_on(rcb_schedule.tails_schedule, deg, str(dev))
    lanes = m.shape[0]
    out = torch.empty((3 * deg, 16, lanes), dtype=torch.int32, device=dev)
    if lanes:
        table = _level_table(levels)
        K.launch("msm_tails", deg, ctypes.addressof(table), nb + 1, m.data_ptr(), lanes,
                 out.data_ptr(), out.stride(0), out.stride(1), sched.data_ptr(), sched.numel(),
                 g, slots, device=dev)
    return out


def tails(deg: int, levels: list, m: torch.Tensor, nb: int) -> torch.Tensor:
    """The bucket-tail prefixes: CUDA planes -> one msm_tails launch, CPU
    planes -> tails_plain."""
    if m.is_cuda:
        return msm_tails_planes(deg, levels, m, nb)
    return tails_plain(deg, levels, m, nb)


def abel_plain(deg: int, heads: torch.Tensor, kw: int) -> torch.Tensor:
    """Plain version of kernel msm_abel, on any device: the heads halved
    down to kw columns."""
    while heads.shape[-1] > kw:
        heads = _add_halves_plain(deg, heads)
    return heads


def msm_abel_planes(deg: int, heads: torch.Tensor, kw: int, plan: list) -> torch.Tensor:
    """The Abel tree of a pass: heads (3 deg, 16, kw 2^R) halved R =
    sum(plan) times -> (3 deg, 16, kw), limb for limb what abel_plain
    gives.  One msm_abel launch an r of `plan` (upsweep_plan.abel_plan), one
    CTA a column of its output, which is the next launch's heads; the inner
    levels stay in shared memory.  CUDA tensors only."""
    check_points(deg, heads, "msm_abel heads")
    dev = K.launch_device("msm_abel", heads)
    if any(r < 1 for r in plan) or heads.shape[2] != kw << sum(plan):
        raise ValueError(f"msm_abel: {heads.shape[2]} heads are not {kw} columns halved "
                         f"by the launches {plan}")
    for r in plan:
        out = torch.empty((3 * deg, 16, heads.shape[2] >> r), dtype=torch.int32, device=dev)
        K.launch("msm_abel", deg, heads.data_ptr(), heads.stride(0), heads.stride(1),
                 out.data_ptr(), out.stride(0), out.stride(1), r, out.shape[2], device=dev)
        heads = out
    return heads


def abel(deg: int, heads: torch.Tensor, kw: int) -> torch.Tensor:
    """The Abel tree of a pass: CUDA planes -> the msm_abel launches of
    abel_plan (one up to c = 11 G1, 10 G2), CPU planes -> abel_plain."""
    if heads.is_cuda:
        return msm_abel_planes(deg, heads, kw, abel_plan(deg, heads.shape[-1], kw))
    return abel_plain(deg, heads, kw)


def _dbl_k(deg: int, p: torch.Tensor, k: int) -> torch.Tensor:
    """k complete doublings, each the plain version."""
    for _ in range(k):
        p = point_double_plain(deg, p)
    return p


def _neg_planes(deg: int, planes: torch.Tensor) -> torch.Tensor:
    out = planes.clone()
    y = slice(deg, 2 * deg)
    out[y] = M.neg_mod(M.FQ, planes[y].transpose(1, 2)).transpose(1, 2)
    return out


def finish_plain(deg: int, tot: torch.Tensor, head: torch.Tensor, c: int, k: int) -> torch.Tensor:
    """Plain version of kernel msm_finish, on any device: (3 deg, 16, k W)
    partials of k sums -> (3 deg, 16, k), every step a plain point op."""
    W = tot.shape[-1] // k
    window_pts = point_add_plain(deg, _dbl_k(deg, tot, c - 1), _neg_planes(deg, head))
    # (W, 3 deg, 16, k): window w of every sum, contiguous
    per_window = window_pts.view(3 * deg, NUM_LIMBS, k, W).permute(3, 0, 1, 2).contiguous()
    acc = C.infinity_planes(deg, k, tot.device)
    for w in range(W - 1, -1, -1):
        acc = point_add_plain(deg, _dbl_k(deg, acc, c), per_window[w])
    return acc


def msm_finish_planes(deg: int, tot: torch.Tensor, head: torch.Tensor, c: int,
                      k: int) -> torch.Tensor:
    """The finish of k sums in one launch of kernel msm_finish: (3 deg, 16,
    k W) partials tot and head -> (3 deg, 16, k) planes, limb for limb what
    finish_plain gives.  CUDA tensors only."""
    check_points(deg, tot, "msm_finish tot")
    check_points(deg, head, "msm_finish head")
    dev = K.launch_device("msm_finish", tot, head)
    if c not in (2, 4, 8, 16):
        raise ValueError(f"msm_finish: window size {c} (2, 4, 8 or 16)")
    W = 256 // c
    if k < 1 or tot.shape != head.shape or tot.shape[2] != k * W:
        raise ValueError(f"msm_finish: {k} sums of {W} windows with partials "
                         f"{tuple(tot.shape)} and {tuple(head.shape)}")
    sched, g, slots = _schedule_on(rcb_schedule.finish_schedule, deg, str(dev))
    per_warp = 32 // g
    warps = min(FINISH_MAX_WARPS, max(k, -(-k * W // per_warp)))        # as the launcher does
    need = 4 * (sched.numel() + 3 * deg * 8 * k * W + warps * per_warp * slots * 8)
    if need > FINISH_SHARED_BYTES:
        raise ValueError(f"msm_finish: {k} sums of {W} windows need {need} bytes of shared "
                         f"memory, more than {FINISH_SHARED_BYTES}")
    out = torch.empty((3 * deg, 16, k), dtype=torch.int32, device=dev)
    K.launch("msm_finish", deg,
             tot.data_ptr(), tot.stride(0), tot.stride(1),
             head.data_ptr(), head.stride(0), head.stride(1),
             out.data_ptr(), out.stride(0), out.stride(1),
             k, W, c, sched.data_ptr(), sched.numel(), g, slots, device=dev)
    return out


def finish(deg: int, tot: torch.Tensor, head: torch.Tensor, c: int, k: int) -> torch.Tensor:
    """The finish of k sums: CUDA planes -> one msm_finish launch, CPU
    planes -> finish_plain."""
    if tot.is_cuda:
        return msm_finish_planes(deg, tot, head, c, k)
    return finish_plain(deg, tot, head, c, k)
