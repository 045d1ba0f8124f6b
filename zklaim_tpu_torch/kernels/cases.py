"""Kernel-versus-plain cases at the shapes the paths give the kernels.

Each Case holds a kernel call and the plain PyTorch version of the same
function on the same inputs, made from a numpy seed.  The card tests
(tests/test_torch_kernels_cuda.py) and chip_smoke.py run them: the two
results must be equal, tolerance 0: limb for limb (integer arithmetic), and
bit for bit for the probe K7's f32fma, whose plain version takes each step
in float64, where it is exact, and rounds once to float32 as the fused
multiply-add does.  The probes K6-K9 run at their originals' shapes and at
small chain lengths K (the plain versions cannot run the originals' K of up
to 120,000 steps); K6 also at the width that fills the card, the shape whose
rate tools/mont_micro.py reports, and on ragged lane counts (a part-full
last CTA; CTAs of one warp); K7 first at the tool's shorter chain, K = 20,000, whose
plain version takes seconds, so that its headline times the kernel's work
and not its launch.  The whole-loop entries run at the
credential path's shapes: mont_pow on 2^15 elements with e = p - 2 (the
batched Fermat inversion of pk_to_bytes), msm_upsweep on the level 0 and
msm_tails on the upsweep levels of a G1 pass of four sums (2^21 lanes) and
of the G2 pass (2^20 lanes) at c = 8, msm_abel on those passes' heads,
msm_finish on the partials of four G1 sums and of one G2 sum at
c = 8, and on one small odd shape.  Their plain versions, like K3's at
2^22, are loops of hundreds of plain products or point operations and take
seconds: `plain_once` tells a caller to run and time them once.  A pass's
front end, msm_digits and msm_gather, runs on the same two passes.

Inputs: random field elements below p; random curve points as host
multiples of the generator (a small pool, gathered to the lane count),
each lane rescaled by a random Fq factor lambda so the projective
coordinates differ lane to lane, with infinity, P + P and P + (-P) lanes
mixed in.

Each Case also carries the work of its call, from which `bound_ms` gives
the least time the card could take for it: the larger of
  - bytes / HBM_BYTES_PER_S: each input read once and each output written
    once, FE_BYTES = 64 bytes per stored field element (16 int32 limbs);
  - multiply-adds / INT32_MAD_PER_S: MADS_PER_PRODUCT 32-bit multiply-adds
    per Montgomery product (csrc/field.cuh's CIOS: 8 rounds of 8 for
    a * b[i], 1 for m = t[0] n', 8 for m * p), times the products per
    element, butterfly or lane.
The data sheet lists no int32 peak for the H100.  Hopper issues int32 on
half of its FP32 lanes, so the rate is taken as the FP32 peak of
67 TFLOP/s, over 2 (an FMA counts as two operations), over 2 again:
16.75e12 multiply-adds per second at the card's full 700 W limit.
tools/mont_micro.py measures the rate the card sustains in Montgomery
products (K6: about 8.0e12).  The bound keeps the assumed rate: a bound is
the least time ANY kernel could take, so it may not rest on a rate that one
implementation reached -- a better product (fewer carry instructions, more
products in flight) would beat a bound built on K6's rate.  chip_smoke.py
prints the share at the measured rate beside it, as a second column.

K7's steps are no Montgomery products, so its cases count single operations
(`ops`) over the rate at which the card starts them, LANE_CLOCKS_PER_S: 132 SMs
of 128 lanes, one instruction a lane a clock, which is the data sheet's
67 TFLOP/s / 2 = 33.5e12 a second.  An integer step is two operations
(the logic op and the add or multiply, which go to different pipes and so
share nothing but the issue slots); an f32fma step is one.  tools/
pallas_op_micro.py measures 15.1-15.3e12 integer steps a second at the width
that fills the card, 91 % of this bound and more than INT32_MAD_PER_S would
allow (that constant is kept for the Montgomery products alone), and
11.9e12, 71 %, at the original's (16, 8192), whose 512 CTAs fill half a
wave (NVIDIA H100 80GB HBM3, 700.00 W).  K7's elements are 4 bytes, counted
in `extra_bytes`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..ec import curve as C
from ..ec import gpu_curve as G
from ..ec.hostcurve import g1_generator, g2_generator
from ..ff import montgomery as M
from ..ff.limbs import ints_to_limbs, to_tensor
from ..ff.montgomery import FQ, FR
from ..msm import gpu_msm
from ..msm.upsweep_plan import upsweep_plan
from ..ntt import gpu_ntt
from ..ntt.radix2 import get_domain


HBM_BYTES_PER_S = 3.35e12
LANE_CLOCKS_PER_S = 67e12 / 2             # operations started: the FP32 FMA peak
INT32_MAD_PER_S = LANE_CLOCKS_PER_S / 2
FE_BYTES = 64
MADS_PER_PRODUCT = 8 * (8 + 1 + 8)
# Fq products per lane: K4 has 12 field products, K5 has 8; over Fq2 each is
# 3 Fq products (Karatsuba), and 3b is a full Fq2 constant product (twice in
# K4, once in K5), where over Fq it is an addition chain.
ADD_PRODUCTS = {1: 12, 2: 12 * 3 + 2 * 3}
DOUBLE_PRODUCTS = {1: 8, 2: 8 * 3 + 3}


@dataclass
class Case:
    kernel: str                        # key of kernels.LAUNCHES
    label: str
    run: Callable[[], torch.Tensor]    # launches the kernel
    plain: Callable[[], torch.Tensor]  # the plain version, same inputs
    elements_moved: int                # field elements read once + written once
    products: int                      # Montgomery products of the call
    ops: int = 0                       # other operations of the call (K7), over LANE_CLOCKS_PER_S
    extra_bytes: int = 0               # bytes moved that are no field elements
    plain_once: bool = False           # the plain version takes seconds: run and time it once


def bound_ms(case: Case, mad_per_s: float = INT32_MAD_PER_S) -> tuple[float, str]:
    """(least milliseconds the card could take for the case's work, the
    side that sets it: "bytes" or "operations").  mad_per_s: the 32-bit
    multiply-add rate to hold the products against (default: the assumed
    peak; chip_smoke.py also passes the rate K6 measured)."""
    by_bytes = (case.elements_moved * FE_BYTES + case.extra_bytes) / HBM_BYTES_PER_S * 1e3
    by_ops = (case.products * MADS_PER_PRODUCT / mad_per_s
              + case.ops / LANE_CLOCKS_PER_S) * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def random_field(spec, n: int, rng: np.random.Generator, device) -> torch.Tensor:
    """(n, 16) int32 canonical limbs of uniform residues mod p."""
    words = rng.integers(0, 1 << 63, size=(n, 5), dtype=np.int64).tolist()
    vals = [
        (w[0] | w[1] << 63 | w[2] << 126 | w[3] << 189 | w[4] << 252) % spec.p
        for w in words
    ]
    vals[:4] = [0, 1, spec.p - 1, spec.p - 2][: len(vals)]
    return to_tensor(ints_to_limbs(vals), device)


def field_edge_values(spec) -> list:
    """The product's edge values: 0, 1, R mod p, p - 1, p - 2, and values
    whose top 32-bit word is p's (0x30644e72, the word the no-carry form of
    csrc/field.cuh's fe_mul rests on)."""
    top = spec.p >> 224 << 224
    return [0, 1, spec.r_mod, spec.p - 1, spec.p - 2, top, top + 1, top + (spec.p - top) // 3,
            spec.p - 3]


def edge_pairs(spec, device) -> tuple:
    """(a, b) as (n, 16) limbs: every pair of field_edge_values."""
    edges = field_edge_values(spec)
    a = [x for x in edges for _ in edges]
    b = edges * len(edges)
    return tuple(to_tensor(ints_to_limbs(v), device) for v in (a, b))


def random_points(deg: int, n: int, rng: np.random.Generator, device,
                  pool: int = 32) -> torch.Tensor:
    """(3 deg, 16, n) planes of random projective points."""
    gen = g1_generator() if deg == 1 else g2_generator()
    f = C.ops_for(deg, plain=True)
    host = [gen * int(rng.integers(1, 1 << 62)) * int(rng.integers(1, 1 << 62))
            for _ in range(pool - 1)]
    host.append(host[0].infinity(gen.b))
    base = C.point_to_planes(f, C.host_points_to_proj(f, host, device))
    idx = torch.from_numpy(rng.integers(0, pool, size=n)).to(device)
    planes = base.index_select(2, idx)
    lam = random_field(FQ, n, rng, device)
    lam[lam.eq(0).all(-1)] = to_tensor(FQ.one_mont, device)
    aos = planes.view(3 * deg, 16, n).transpose(1, 2)          # (3 deg, n, 16)
    return M.mont_mul_plain(FQ, aos, lam).transpose(1, 2).contiguous()


def _neg_lanes(deg: int, planes: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    out = planes.clone()
    y = planes[deg : 2 * deg].transpose(1, 2)
    out[deg : 2 * deg] = torch.where(mask[:, None], M.neg_mod(FQ, y), y).transpose(1, 2)
    return out


def curve_inputs(deg: int, n: int, rng: np.random.Generator, device):
    """(p, q) plane sets: random lanes, with every 8th lane q = p, every
    8th (offset 1) q = -p, and infinity wherever the pool drew it."""
    p = random_points(deg, n, rng, device)
    q = random_points(deg, n, rng, device)
    lane = torch.arange(n, device=device)
    q = torch.where((lane % 8 == 0), p, q)
    q = torch.where((lane % 8 == 1), _neg_lanes(deg, p, lane % 8 == 1), q)
    return p, q


def kernel_cases(device, n_field: int = 1 << 15, n_ntt: int = 1 << 15, n_ntt_big: int = 1 << 22,
                 n_g1: int = 1 << 16, n_g2: int = 1 << 15, seed: int = 0) -> list:
    """The kernels of the proving paths at the given widths (defaults: the
    main path's; K1 also on every pair of the edge values of both fields
    (edge_pairs) and on an unaligned operand; K2 also through its
    gather entry; K2 and K3 also at the bench's largest transform,
    n_ntt_big, K3 there in two passes, and on the four-step NTT's batches
    (batched_ntt_cases); the doubling also at 4 G1
    lanes and 1 G2 lane, where a launch is all host), msm_upsweep, msm_abel
    and msm_tails at the credential path's shapes (upsweep_cases,
    tails_cases), mont_pow and msm_finish at theirs (loop_cases), the
    four probes (probe_cases), then msm_digits and msm_gather at a pass's
    (front_cases)."""
    rng = np.random.default_rng(seed)
    cases = []
    for spec in (FR, FQ):
        a, b = (random_field(spec, n_field, rng, device) for _ in range(2))
        cases.append(Case("mont_mul", f"K1 mont_mul {spec.name} n={n_field}",
                          lambda s=spec, a=a, b=b: M.mont_mul(s, a, b),
                          lambda s=spec, a=a, b=b: M.mont_mul_plain(s, a, b),
                          3 * n_field, n_field))
    for es in (FQ, FR):
        ea, eb = edge_pairs(es, device)
        cases.append(Case("mont_mul", f"K1 mont_mul {es.name} edge values, all {ea.shape[0]} pairs",
                          lambda s=es, a=ea, b=eb: M.mont_mul(s, a, b),
                          lambda s=es, a=ea, b=eb: M.mont_mul_plain(s, a, b),
                          3 * ea.shape[0], ea.shape[0]))
    # the last random product again on an operand 4 bytes off 16-byte alignment: K1
    # then takes its strided scalar loads, the path of every odd view
    buf = torch.zeros(n_field * 16 + 4, dtype=torch.int32, device=device)
    off = buf[1 : 1 + n_field * 16].view(n_field, 16)
    off.copy_(a)
    cases.append(Case("mont_mul", f"K1 mont_mul {spec.name} n={n_field} unaligned operand",
                      lambda s=spec, a=off, b=b: M.mont_mul(s, a, b),
                      lambda s=spec, a=off, b=b: M.mont_mul_plain(s, a, b),
                      3 * n_field, n_field))

    # a run of stages reads and writes the n elements once and reads the
    # twiddles of its stages (2^s at stage s); one product per butterfly.
    # K2's gather entry (a transform's first step) reads the n rows of the
    # AoS input in bit-reversed order and writes new planes: the same work.
    # The in-place entries run on a copy of their input, whose time their
    # call and device times include (tools/ntt_profile.py times them alone).
    for n, once in ((n_ntt, False), (n_ntt_big, True)):
        dom = get_domain(n, str(device))
        lt = min(gpu_ntt.TILE, n).bit_length() - 1
        x = _fr_planes(n, rng, device)
        rows = x.t().contiguous()
        passes = len(gpu_ntt.global_passes(n))
        for tw, name in ((dom.tw_flat, "forward"), (dom.tw_inv_flat, "inverse")):
            if name == "forward":             # the entry every transform takes: K2's headline
                cases.append(Case("ntt_local", f"K2 ntt_local_rows (bit-reversal gather) {name} "
                                               f"n={n}",
                                  lambda r=rows, tw=tw: gpu_ntt.ntt_local_rows(r, tw),
                                  lambda r=rows, tw=tw, lt=lt: gpu_ntt.ntt_plain(
                                      r.index_select(0, gpu_ntt.bitrev_rows(r.shape[0], r.device))
                                      .t().contiguous(), tw, range(lt)),
                                  2 * n + (1 << lt) - 1, lt * n // 2, plain_once=once))
            cases.append(Case("ntt_local", f"K2 ntt_local {name} n={n}",
                              lambda x=x, tw=tw: gpu_ntt.ntt_local(x.clone(), tw),
                              lambda x=x, tw=tw, lt=lt: gpu_ntt.ntt_plain(x, tw, range(lt)),
                              2 * n + (1 << lt) - 1, lt * n // 2, plain_once=once))
            if dom.k > lt:
                cases.append(Case("ntt_stage", f"K3 ntt_stage {name} n={n} ({passes} passes)",
                                  lambda x=x, tw=tw: gpu_ntt.ntt_global(x.clone(), tw),
                                  lambda x=x, tw=tw, lt=lt, k=dom.k: gpu_ntt.ntt_plain(
                                      x, tw, range(lt, k)),
                                  2 * n + (1 << dom.k) - (1 << lt), (dom.k - lt) * n // 2,
                                  plain_once=once))

    cases += batched_ntt_cases(device, rng)

    for deg, n in ((1, n_g1), (2, n_g2)):
        p, q = curve_inputs(deg, n, rng, device)
        cases.append(Case("point_add", f"K4 point_add G{deg} n={n}",
                          lambda d=deg, p=p, q=q: G.point_add_planes(d, p, q),
                          lambda d=deg, p=p, q=q: G.point_add_plain(d, p, q),
                          9 * deg * n, ADD_PRODUCTS[deg] * n))
    p, _ = curve_inputs(1, n_g1, rng, device)
    cases.append(Case("point_add", f"K4 point_add_halves G1 n={n_g1}",
                      lambda p=p: G.point_add_halves(1, p),
                      lambda p=p: G.point_add_plain(1, p[..., : n_g1 // 2], p[..., n_g1 // 2 :]),
                      9 * n_g1 // 2, ADD_PRODUCTS[1] * n_g1 // 2))

    for deg, n in ((1, n_g1), (2, n_g2), (1, 4), (2, 1)):
        p = random_points(deg, n, rng, device)
        cases.append(Case("point_double", f"K5 point_double G{deg} n={n}",
                          lambda d=deg, p=p: G.point_double_planes(d, p),
                          lambda d=deg, p=p: G.point_double_plain(d, p),
                          6 * deg * n, DOUBLE_PRODUCTS[deg] * n))
    return (cases + upsweep_cases(device, rng) + tails_cases(device, rng)
            + loop_cases(device, rng, n_field) + probe_cases(device, rng)
            + front_cases(device, rng))


def batched_ntt_cases(device, rng: np.random.Generator,
                      shapes=((256, 128), (128, 256), (2048, 2048))) -> list:
    """K2 and K3 on a batch of B transforms of n in one launch (one a K3
    pass), at the four-step NTT's (n, B): at 2^15 the 128 column transforms
    of 256 and the 256 row transforms of 128 (K2 alone), at 2^22 2,048 of
    2,048 (K2 and one K3 pass).  K2 through its rows entry on the (n, B, 16)
    input, as NTTDomain.ntt calls it; K3 in place on a copy of planes.  Work
    as for one transform, B times; the twiddles are read once."""
    cases = []
    for n, batch in shapes:
        dom = get_domain(n, str(device))
        lt = min(gpu_ntt.TILE, n).bit_length() - 1
        planes = _fr_planes(batch * n, rng, device)
        rows = planes.view(16, batch, n).permute(2, 1, 0).contiguous()       # (n, B, 16)
        once = batch * n > 1 << 20
        tw = dom.tw_flat
        cases.append(Case("ntt_local", f"K2 ntt_local_rows batched, {batch} transforms of {n}",
                          lambda r=rows, tw=tw: gpu_ntt.ntt_local_rows(r, tw),
                          lambda r=rows, tw=tw, lt=lt, n=n: gpu_ntt.ntt_plain(
                              r.index_select(0, gpu_ntt.bitrev_rows(n, r.device))
                              .permute(2, 1, 0).reshape(16, -1).contiguous(), tw, range(lt)),
                          2 * batch * n + (1 << lt) - 1, lt * batch * n // 2, plain_once=once))
        if dom.k > lt:
            passes = len(gpu_ntt.global_passes(n, batch=batch))
            cases.append(Case("ntt_stage", f"K3 ntt_stage batched, {batch} transforms of {n} "
                                           f"({passes} pass)",
                              lambda x=planes, tw=tw, n=n: gpu_ntt.ntt_global(x.clone(), tw, n=n),
                              lambda x=planes, tw=tw, lt=lt, k=dom.k: gpu_ntt.ntt_plain(
                                  x, tw, range(lt, k)),
                              2 * batch * n + (1 << dom.k) - (1 << lt),
                              (dom.k - lt) * batch * n // 2, plain_once=once))
    return cases


def _fr_planes(n: int, rng: np.random.Generator, device) -> torch.Tensor:
    """(16, n) planes of random canonical Fr elements, drawn in bulk (16-bit
    limbs, the top one below r's, 0x3064), 0, 1, r - 1 and r - 2 first."""
    limbs = rng.integers(0, 1 << 16, size=(n, 16))
    limbs[:, 15] = rng.integers(0, 0x3064, size=n)
    edges = ints_to_limbs([0, 1, FR.p - 1, FR.p - 2])[: n]
    limbs[: len(edges)] = edges
    return torch.from_numpy(limbs.astype(np.int32)).t().contiguous().to(device)


def pass_points(deg: int, lanes: int, rng: np.random.Generator, device) -> torch.Tensor:
    """(3 deg, 16, lanes) planes as a pass's gather gives them: random points,
    a pool of up to 4,096 gathered to the lanes."""
    pool = random_points(deg, min(lanes, 1 << 12), rng, device)
    idx = torch.from_numpy(rng.integers(0, pool.shape[2], size=lanes)).to(device)
    return pool.index_select(2, idx)


def front_inputs(deg: int, k: int, c: int, lanes: int, rng: np.random.Generator, device):
    """(rows, scalars) of a pass of k sums at window size c over `lanes`
    lanes: k tables of n = lanes / (k W) random points (pass_points, with
    infinity among them) and of n random Fr scalars, the last quarter of the
    first sum 0 as msm_many pads a sum."""
    n = lanes // (k * (256 // c))
    rows = [C.planes_to_rows(pass_points(deg, n, rng, device)) for _ in range(k)]
    scalars = [_fr_planes(n, rng, device).t().contiguous() for _ in range(k)]
    scalars[0][n - n // 4 :] = 0
    return rows, scalars


def front_cases(device, rng: np.random.Generator,
                passes=((1, 4, 8, 1 << 21), (2, 1, 8, 1 << 20))) -> list:
    """msm_digits and msm_gather at (deg, k, c, lanes) passes -- by default a
    G1 chunk of four sums at c = 8 and the G2 sum, the credential path's --
    on front_inputs, msm_gather on the plain keys' stable sort.  Work:
    msm_digits reads the k n scalars and writes a key and an index, 8
    bytes, a lane; msm_gather reads each of the k n rows once (a pass's
    table stays in L2 for its W reads), the index and the permutation (12
    bytes a lane), and writes every lane's point."""
    cases = []
    for deg, k, c, lanes in passes:
        rows, scalars = front_inputs(deg, k, c, lanes, rng, device)
        n, nb = rows[0].shape[0], lanes.bit_length() - 1
        cases.append(Case("msm_digits", f"msm_digits k={k} c={c} lanes=2^{nb}",
                          lambda s=scalars, c=c: gpu_msm.digit_keys(s, c),
                          lambda s=scalars, c=c: gpu_msm.digit_keys_plain(s, c),
                          k * n, 0, extra_bytes=8 * lanes))
        keys, idx = gpu_msm.digit_keys_plain(scalars, c)
        perm = torch.sort(keys, stable=True)[1]
        cases.append(Case("msm_gather", f"msm_gather G{deg} k={k} c={c} lanes=2^{nb}",
                          lambda d=deg, r=rows, i=idx, p=perm, nb=nb: gpu_msm.signed_gather(
                              d, r, i, p, nb),
                          lambda d=deg, r=rows, i=idx, p=perm, nb=nb: gpu_msm.signed_gather_plain(
                              d, r, i, p, nb),
                          3 * deg * (k * n + lanes), 0, extra_bytes=12 * lanes))
    return cases


def tail_inputs(deg: int, k: int, c: int, lanes: int, rng: np.random.Generator, device):
    """(levels, m, nb) as a pass of k sums at window size c over a flat batch
    of `lanes` lanes makes them: pass_points, the upsweep of the device
    (msm_upsweep on the card, its plain version on the CPU), and the prefix
    lengths at the k W (B + 1) bucket tails of digit magnitudes drawn as |d|
    of uniform c-bit signed digits, sorted by window as the pass sorts
    them."""
    W, B = 256 // c, 1 << (c - 1)
    nb = lanes.bit_length() - 1
    levels = gpu_msm.upsweep(deg, pass_points(deg, lanes, rng, device))
    win = np.arange(k * W)[:, None]
    keys = np.sort((win * (B + 1) + np.abs(rng.integers(-B, B, size=(k * W, lanes // (k * W)))))
                   .reshape(-1))
    m = np.searchsorted(keys, (win * (B + 1) + np.arange(B + 1)).reshape(-1), side="right")
    return levels, torch.from_numpy(m.astype(np.int64)).to(device), nb


def tails_cases(device, rng: np.random.Generator,
                tails=((1, 4, 8, 1 << 21), (2, 1, 8, 1 << 20))) -> list:
    """msm_tails at (deg, k, c, lanes) passes -- by default a G1 chunk of four
    sums at c = 8 and the G2 sum, the credential path's -- on levels built
    once.  Work, from this run's prefix lengths: the nodes read (one a set bit
    of m, over the nb + 1 levels) and the lanes written, 3 deg field elements
    each, and m read; popcount(m) adds a lane."""
    cases = []
    for deg, k, c, lanes in tails:
        levels, m, nb = tail_inputs(deg, k, c, lanes, rng, device)
        mask = (2 << nb) - 1
        adds = sum(bin(v & mask).count("1") for v in m.tolist())
        cases.append(Case("msm_tails", f"K4 msm_tails G{deg} k={k} c={c} lanes=2^{nb} "
                                       f"tails={m.shape[0]} adds={adds}",
                          lambda d=deg, lv=levels, m=m, nb=nb: gpu_msm.tails(d, lv, m, nb),
                          lambda d=deg, lv=levels, m=m, nb=nb: gpu_msm.tails_plain(d, lv, m, nb),
                          3 * deg * (adds + m.shape[0]), ADD_PRODUCTS[deg] * adds,
                          extra_bytes=8 * m.shape[0], plain_once=True))
    return cases


def upsweep_cases(device, rng: np.random.Generator, passes=((1, 4, 8, 1 << 21), (2, 1, 8, 1 << 20))
                  ) -> list:
    """msm_upsweep and msm_abel at (deg, k, c, lanes) passes -- by default a G1
    chunk of four sums at c = 8 and the G2 sum, the credential path's: the
    upsweep of the pass's level 0 (pass_points) and the Abel tree of its
    B k W heads (random points) to k W columns.  Work: the upsweep reads
    level 0 once and writes every level once (2^nb - 1 adds); the Abel tree
    reads the heads and writes k W points ((B - 1) k W adds)."""
    cases = []
    for deg, k, c, lanes in passes:
        nb = lanes.bit_length() - 1
        level0 = pass_points(deg, lanes, rng, device)
        launches = len(upsweep_plan(deg, nb))
        cases.append(Case("msm_upsweep", f"K4 msm_upsweep G{deg} k={k} c={c} lanes=2^{nb} "
                                         f"({launches} launches)",
                          lambda d=deg, x=level0: gpu_msm.upsweep(d, x),
                          lambda d=deg, x=level0: gpu_msm.upsweep_plain(d, x),
                          3 * deg * (2 * lanes - 1), ADD_PRODUCTS[deg] * (lanes - 1),
                          plain_once=True))
    for deg, k, c, _ in passes:
        kw, B = k * 256 // c, 1 << (c - 1)
        heads = pass_points(deg, B * kw, rng, device)
        cases.append(Case("msm_abel", f"K4 msm_abel G{deg} k={k} c={c} heads={B * kw} to {kw}",
                          lambda d=deg, x=heads, kw=kw: gpu_msm.abel(d, x, kw),
                          lambda d=deg, x=heads, kw=kw: gpu_msm.abel_plain(d, x, kw),
                          3 * deg * (B * kw + kw), ADD_PRODUCTS[deg] * (B - 1) * kw,
                          plain_once=True))
    return cases


def loop_cases(device, rng: np.random.Generator, n_pow: int = 1 << 15,
               finishes=((1, 4, 8), (2, 1, 8), (1, 2, 4))) -> list:
    """The whole-loop entries.  mont_pow: a^(p-2) on n_pow elements of each
    field, zero, one and p - 1 among them; work: n_pow in and out, and
    nbits - 1 squarings + popcount(e) products an element (the kernel's
    chain).  msm_finish: (deg, k, c) finishes on partials drawn as
    curve_inputs draws them (infinity, tot = head and tot = -head lanes);
    work: both partials in, k points out; per window lane (c - 1) doublings
    and an add, per sum and window c doublings and an add."""
    cases = []
    for spec in (FQ, FR):
        a = random_field(spec, n_pow, rng, device)
        bits = spec.exp_p_minus_2_bits
        products = (spec.p - 2).bit_length() - 1 + int(bits.sum())
        cases.append(Case("mont_pow", f"K1 mont_pow {spec.name} n={n_pow} e={spec.name[1]}-2",
                          lambda s=spec, a=a, b=bits: M.mont_pow_bits(s, a, b),
                          lambda s=spec, a=a, b=bits: M.mont_pow_bits_plain(s, a, b),
                          2 * n_pow, products * n_pow, plain_once=True))
    for deg, k, c in finishes:
        W = 256 // c
        tot, head = curve_inputs(deg, k * W, rng, device)
        per_lane = ((c - 1) + c) * DOUBLE_PRODUCTS[deg] + 2 * ADD_PRODUCTS[deg]
        cases.append(Case("msm_finish", f"K5 msm_finish G{deg} k={k} W={W} c={c}",
                          lambda d=deg, t=tot, h=head, c=c, k=k: gpu_msm.finish(d, t, h, c, k),
                          lambda d=deg, t=tot, h=head, c=c, k=k: gpu_msm.finish_plain(
                              d, t, h, c, k),
                          3 * deg * (2 * k * W + k), per_lane * k * W, plain_once=True))
    return cases


def probe_cases(device, rng: np.random.Generator, k_mont: int = 16, k_op: int = 16,
                k_op_long: int | None = None, k_add: int = 5, n_tiled: int | None = None,
                wide_lanes: int | None = None, k_wide: int = 2,
                n_ragged: int | None = None) -> list:
    """The probes K6-K9 at their originals' shapes and small chain lengths,
    K6 also at the card's width (wide_lanes, default mont_micro.WIDE_LANES)
    and at ragged lane counts (1,023 and 1,101 in CTAs of one warp,
    wide_lanes + 77 in CTAs of 256; 3 steps), K7 first at the tool's own chain length
    (k_op_long, default pallas_op_micro.CHAIN[0] = 20,000: its headline, where
    the work and not the launch is timed; plain_once) and then at k_op, K8
    also on a ragged lane count at every tile (n_ragged, default 2^15 + 77:
    no tile divides it, and the last CTA of every tile is part full).

    Work of a call: K6 k products a lane; K7 k steps an element (see the
    module docstring); K8 as K4; K9 12 k products a lane."""
    from ..tools import grid_micro, mont_micro, padd_micro, pallas_op_micro

    def field_planes(base, lanes):          # (16, lanes): base's lanes tiled
        return base.repeat(-(-lanes // base.shape[0]), 1)[:lanes].t().contiguous()

    def mont(lanes, k, x, what=""):
        cases.append(Case("mont_chain", f"K6 mont_chain Fq lanes={lanes} K={k}{what}",
                          lambda x=x, k=k: mont_micro.mont_chain(x, k),
                          lambda x=x, k=k: mont_micro.mont_chain_plain(x, k),
                          2 * lanes, k * lanes))

    cases = []
    lanes, wide = mont_micro.LANES, wide_lanes or mont_micro.WIDE_LANES
    mont(lanes, k_mont, field_planes(random_field(FQ, lanes, rng, device), lanes))
    wide_base = random_field(FQ, min(wide, 1 << 14), rng, device)      # tiled above 2^14 lanes
    mont(wide, k_wide, field_planes(wide_base, wide))
    for n in (lanes - 1, lanes + 77, wide + 77):            # ragged: a part-full last CTA
        mont(n, 3, field_planes(wide_base, n), " (ragged)")

    rows, cols = pallas_op_micro.ROWS, pallas_op_micro.COLS
    inputs = {op: pallas_op_micro.probe_input(op, cols, device, int(rng.integers(1 << 30)))
              for op in ("u32mul", "u32add", "u16mul", "f32fma")}
    for k, once in ((k_op_long or pallas_op_micro.CHAIN[0], True), (k_op, False)):
        for op, v in inputs.items():
            cases.append(Case("op_chain", f"K7 op_chain {op} ({rows}, {cols}) K={k}",
                              lambda op=op, v=v, k=k: pallas_op_micro.op_chain(op, v, k),
                              lambda op=op, v=v, k=k: pallas_op_micro.op_chain_plain(op, v, k),
                              0, 0, ops=(1 if op == "f32fma" else 2) * k * v.numel(),
                              extra_bytes=2 * 4 * v.numel(), plain_once=once))

    def tiled(n, what):
        p, q = curve_inputs(1, n, rng, device)
        for tile in dict.fromkeys(min(t, n) for t in grid_micro.TILES):
            cases.append(Case("point_add_tiled", f"K8 point_add_tiled G1 n={n}{what} tile={tile} "
                                                 f"threads={grid_micro.tiled_threads(tile)}",
                              lambda t=tile: grid_micro.point_add_tiled(p, q, t),
                              lambda t=tile: grid_micro.point_add_tiled_plain(p, q, t),
                              9 * n, ADD_PRODUCTS[1] * n))

    tiled(n_tiled or grid_micro.N, "")
    lanes = padd_micro.LANES
    pt = random_points(1, lanes, rng, device)
    cases.append(Case("point_add_chain", f"K9 point_add_chain G1 lanes={lanes} K={k_add}",
                      lambda: padd_micro.point_add_chain(pt, k_add),
                      lambda: padd_micro.point_add_chain_plain(pt, k_add),
                      6 * lanes, ADD_PRODUCTS[1] * k_add * lanes))
    tiled(n_ragged or grid_micro.N + 77, " (ragged)")
    return cases


def max_abs_err(a, b):
    """Largest difference of two results (0 when they are identical): an int
    for limbs and bit patterns, a float for float32 results; over two lists
    of tensors (the upsweep's levels), the largest of their pairs'."""
    if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
        if len(a) != len(b):
            raise ValueError(f"mismatch: {len(a)} results vs {len(b)}")
        return max((max_abs_err(x, y) for x, y in zip(a, b)), default=0)
    if a.shape != b.shape or a.dtype != b.dtype:
        raise ValueError(f"mismatch {tuple(a.shape)} {a.dtype} vs {tuple(b.shape)} {b.dtype}")
    if not a.numel():
        return 0
    if a.is_floating_point():
        return float((a.double() - b.double()).abs().max().item())
    return int((a.long() - b.long()).abs().max().item())

