"""Complete point add and doubling on (3 deg, 16, n) limb planes, and the
MSM stages built from them: kernels K4 (point_add, msm_tails) and K5
(point_double, msm_finish).

Counterpart of zklaim_tpu/ec/pallas_curve.py (point_add_planes,
point_add_halves, point_double).  A point batch of width n is one int32
tensor of 3 * deg planes, each (16, n) limbs; G2 planes are
(x0, x1, y0, y1, z0, z1).

On a CUDA tensor each call is one K4 or K5 launch, and a build or launch
that fails raises; on a CPU tensor it runs `point_add_plain` /
`point_double_plain`, the plain versions (curve.point_add,
curve.point_double).

`scalar_mul` is the counterpart of jaxcurve.scalar_mul on planes: the
batched double-and-add ladder, each step one K5, one K4 and a select.

`msm_finish_planes` is the whole finish of a Pippenger pass -- the window
doublings and the Horner ladder of k sums -- as ONE launch of kernel
msm_finish, CUDA tensors only; its plain version is
msm.pippenger._finish_plain.

`msm_tails_planes` (K4's second entry) is the whole bucket-tail stage of a
pass -- for every tail lane one add per set bit of its prefix length, from
the upsweep levels -- as ONE launch of kernel msm_tails, CUDA tensors only;
its plain version is msm.pippenger._tails_plain.

`msm_upsweep_planes` (K4's third entry) builds every upsweep level of a pass
from level 0 in the few launches of a plan (msm/upsweep_plan.py:
upsweep_plan), `msm_abel_planes` (the fourth) halves a pass's Abel heads to
its window columns in the launches of abel_plan (one up to c = 11 G1, 10
G2), CUDA tensors only; their plain versions
are msm.pippenger._upsweep_plain and _abel_plain, the loops of the add.

`msm_digit_keys` and `msm_gather_planes` are a pass's front end
(csrc/msm.cu): the signed digits of k scalar tables as the sort's keys and
the pre-resolved gather index (kernel msm_digits), and the sorted lanes
gathered, bit-reversed and sign-resolved into level 0's planes (kernel
msm_gather), CUDA tensors only; their plain versions are
msm.pippenger._digit_keys_plain and _signed_gather_plain.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels as K
from ..ff.limbs import LIMB_BITS, NUM_LIMBS
from ..utils.device_cache import device_constant
from . import curve as C
from . import rcb_schedule


def point_add_plain(deg: int, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Plain version of K4 on planes, on any device."""
    f = C.ops_for(deg, plain=True)
    r = C.point_add(f, C.planes_to_point(f, p), C.planes_to_point(f, q))
    return C.point_to_planes(f, r)


def _check(deg: int, t: torch.Tensor, what: str) -> None:
    K.check_planes(t, what)
    unit = t.dim() == 3 and (t.shape[2] <= 1 or t.stride(2) == 1)
    if not unit or t.shape[0] != 3 * deg or t.shape[1] != 16:
        raise ValueError(
            f"{what}: expected ({3 * deg}, 16, n) planes with unit element stride, "
            f"got shape {tuple(t.shape)} strides {t.stride()}"
        )


def point_add_planes(deg: int, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """p + q lane by lane: two (3 deg, 16, n) plane sets -> a new one."""
    if not p.is_cuda:
        return point_add_plain(deg, p, q)
    _check(deg, p, "point_add p")
    _check(deg, q, "point_add q")
    dev = K.launch_device("point_add", p, q)
    if p.shape != q.shape:
        raise ValueError(f"point_add: operand mismatch {tuple(p.shape)} vs {tuple(q.shape)}")
    n = p.shape[2]
    out = torch.empty((3 * deg, 16, n), dtype=torch.int32, device=dev)
    if n:
        K.launch("point_add", deg,
                 p.data_ptr(), p.stride(0), p.stride(1),
                 q.data_ptr(), q.stride(0), q.stride(1),
                 out.data_ptr(), out.stride(0), out.stride(1), n, device=dev)
    return out


def point_add_halves(deg: int, planes: torch.Tensor) -> torch.Tensor:
    """Sum of the contiguous halves: (3 deg, 16, w) -> (3 deg, 16, w/2).

    The halves are two strided views of `planes`: no copy on either device."""
    w = planes.shape[-1]
    if w % 2:
        raise ValueError(f"point_add_halves: odd width {w}")
    return point_add_planes(deg, planes[..., : w // 2], planes[..., w // 2 :])


def point_double_plain(deg: int, p: torch.Tensor) -> torch.Tensor:
    """Plain version of K5 on planes, on any device."""
    f = C.ops_for(deg, plain=True)
    return C.point_to_planes(f, C.point_double(f, C.planes_to_point(f, p)))


def point_double_planes(deg: int, p: torch.Tensor) -> torch.Tensor:
    """2p lane by lane: (3 deg, 16, n) planes -> a new plane set."""
    if not p.is_cuda:
        return point_double_plain(deg, p)
    _check(deg, p, "point_double p")
    dev = K.launch_device("point_double", p)
    n = p.shape[2]
    out = torch.empty((3 * deg, 16, n), dtype=torch.int32, device=dev)
    if n:
        K.launch("point_double", deg,
                 p.data_ptr(), p.stride(0), p.stride(1),
                 out.data_ptr(), out.stride(0), out.stride(1), n, device=dev)
    return out


def scalar_mul(deg: int, planes: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """Batched double-and-add: scalars[i] * point[i] -> (3 deg, 16, n) planes.

    planes: (3 deg, 16, n) points; scalars: (n, 16) plain-domain (NOT
    Montgomery) int32 limbs.  256 steps, MSB first, the dataflow of
    jaxcurve.scalar_mul: double (K5), add the point (K4), keep the sum where
    the scalar's bit is set."""
    n = planes.shape[2]
    if scalars.shape != (n, NUM_LIMBS):
        raise ValueError(f"scalar_mul: {n} points with scalars {tuple(scalars.shape)}")
    acc = C.infinity_planes(deg, n, planes.device)
    for bit_index in range(255, -1, -1):
        bit = (scalars[:, bit_index // LIMB_BITS] >> (bit_index % LIMB_BITS)) & 1
        acc = point_double_planes(deg, acc)
        acc = torch.where(bit == 1, point_add_planes(deg, acc, planes), acc)
    return acc


FINISH_SHARED_BYTES = 227 * 1024     # what a CTA can opt in to (csrc/curve.cu:FIN_SHARED_MAX)
FINISH_MAX_WARPS = 16                # csrc/curve.cu:FIN_THREADS / 32
TAILS_MAX_LEVELS = 32                # csrc/curve.cu:TAIL_MAX_LEVELS


@device_constant
def _schedule_on(build, deg: int, device: str) -> tuple:
    """(the packed schedule build(deg) on the device, its group size, its
    slot count), uploaded once."""
    sched = build(deg)
    words = torch.from_numpy(rcb_schedule.pack(sched).view("int32").copy())   # the same bits
    return words.to(device), sched["g"], sched["slots"]


def msm_finish_planes(deg: int, tot: torch.Tensor, head: torch.Tensor, c: int,
                      k: int) -> torch.Tensor:
    """The finish of k sums in one launch: (3 deg, 16, k W) window partials
    `tot` and `head` (window w of sum i is lane i W + w, W = 256 / c) ->
    (3 deg, 16, k) planes, sum i = sum_w 2^(c w) (2^(c-1) tot - head)[i W + w],
    limb for limb what pippenger._finish_plain gives.  CUDA tensors only."""
    _check(deg, tot, "msm_finish tot")
    _check(deg, head, "msm_finish head")
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


def msm_tails_planes(deg: int, levels: list, m: torch.Tensor, nb: int) -> torch.Tensor:
    """The bucket-tail prefixes of a flat batch of 2^nb lanes in one launch.
    levels: the nb + 1 upsweep levels, level t (3 deg, 16, 2^(nb-t)) planes
    (any plane and row strides); m: (L,) int64 prefix lengths.  -> (3 deg,
    16, L) planes: lane i is the sum, lowest level first, of the node of
    each level t whose bit of m[i] is set, limb for limb what
    pippenger._tails_plain gives.  CUDA tensors only."""
    if m.dtype != torch.int64 or m.dim() != 1 or not m.is_contiguous():
        raise ValueError(f"msm_tails: m must be a contiguous (L,) int64 vector, got "
                         f"{m.dtype} {tuple(m.shape)}")
    if not 0 <= nb < TAILS_MAX_LEVELS or len(levels) != nb + 1:
        raise ValueError(f"msm_tails: {len(levels)} levels for a batch of 2^{nb} lanes "
                         f"(nb + 1 levels, at most {TAILS_MAX_LEVELS})")
    for t, lvl in enumerate(levels):
        _check(deg, lvl, f"msm_tails level {t}")
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


def _level_table(levels: list):
    """(base, plane stride, limb stride) a level, as the C launchers read
    them: a by-value table copied into the launch."""
    words = [v for lvl in levels for v in (lvl.data_ptr(), lvl.stride(0), lvl.stride(1))]
    return (ctypes.c_longlong * len(words))(*words)


def msm_upsweep_planes(deg: int, level0: torch.Tensor, plan: list) -> list:
    """Every upsweep level of a flat batch of 2^nb lanes: level0 (3 deg, 16,
    2^nb) planes -> [level0, level 1, ..., level nb], level t (3 deg, 16,
    2^(nb-t)) with column j = column j + column j + 2^(nb-t) of level t - 1,
    limb for limb what pippenger._upsweep_plain gives.  Levels 1 ... nb are
    views into one buffer (the tails read them by their strides).  One
    msm_upsweep launch a (t, r, T) of `plan` (upsweep_plan.upsweep_plan),
    which must cover levels 1 ... nb in order.  CUDA tensors only."""
    _check(deg, level0, "msm_upsweep level 0")
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


def msm_abel_planes(deg: int, heads: torch.Tensor, kw: int, plan: list) -> torch.Tensor:
    """The Abel tree of a pass: heads (3 deg, 16, kw 2^R), b-major and
    window-minor, halved R = sum(plan) times -> (3 deg, 16, kw), limb for
    limb what pippenger._abel_plain gives.  One msm_abel launch an r of
    `plan` (upsweep_plan.abel_plan), one CTA a column of its output, which is
    the next launch's heads; the inner levels stay in shared memory.  CUDA
    tensors only."""
    _check(deg, heads, "msm_abel heads")
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


FRONT_MAX_SUMS = 64                  # csrc/msm.cu:FRONT_MAX_SUMS


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


def msm_digit_keys(scalars: list, c: int) -> tuple:
    """A pass's digits in one launch of kernel msm_digits: k (n, 16)
    plain-domain scalar tables -> (keys, idx), each (k W n,) int32, W =
    256 / c.  Lane (i W + w) n + j is window w of scalar j of sum i: key
    (i W + w) (B + 1) + |d| (B = 2^(c-1), d its signed digit), index 2 k n
    for d = 0, i n + j for d > 0 and k n + i n + j for d < 0.  Limb for limb
    what pippenger._digit_keys_plain gives.  CUDA tensors only."""
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


@device_constant
def _infinity_row_on(deg: int, device: str) -> torch.Tensor:
    """The packed infinity row on the device, made once."""
    return C.planes_to_rows(C.infinity_planes(deg, 1, device)).reshape(-1)


def msm_gather_planes(deg: int, rows: list, idx: torch.Tensor, perm: torch.Tensor,
                      nb: int) -> torch.Tensor:
    """Level 0 of a pass in one launch of kernel msm_gather: k (n, 48 deg)
    packed point tables, the gather index idx (2^nb,) int32 of
    msm_digit_keys and the stable sort's permutation perm (2^nb,) int64 ->
    (3 deg, 16, 2^nb) planes, lane q the point of sorted lane rev_nb(q):
    infinity where idx[perm[.]] = 2 k n, else row idx mod k n of the
    tables laid end to end, its y negated where idx >= k n.  Limb for limb
    what pippenger._signed_gather_plain gives.  The index is trusted: it
    must come from msm_digit_keys over the same k and n.  CUDA tensors only."""
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
