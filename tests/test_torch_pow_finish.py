"""The two whole-loop entries of the port on the CPU: the fixed-exponent
power (ff.montgomery.mont_pow_bits, kernel mont_pow on the card) and the MSM
finish (msm.gpu_msm.finish, kernel msm_finish on the card).

On CPU tensors both dispatchers run their plain versions; these are held to
the JAX package (zklaim_tpu.ff.montgomery.mont_pow_bits, msm.pippenger._finish)
limb for limb and to Python integers / hostcurve.  The schedule that the
kernel msm_finish interprets (ec.rcb_schedule) is run here on Python integers,
step by step as the kernel runs it, and held to the plain point formulas and
to finish_plain; the packed words are decoded as csrc/curve.cu decodes them.
Integer arithmetic throughout: tolerance 0.  Sizes are small: short
exponents (the eager JAX loop costs a product a bit), c = 16 finishes except
for the one comparison with the JAX _finish, which reuses the shapes
test_torch_double compiles.
"""

import random
import re
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from zklaim_tpu.ec import jaxcurve as JC
from zklaim_tpu.ff import montgomery as JM
from zklaim_tpu.msm import pippenger as JP

from zklaim_tpu_torch import kernels as K
from zklaim_tpu_torch.ec import curve as C
from zklaim_tpu_torch.ec import rcb_schedule as S
from zklaim_tpu_torch.ec.hostcurve import g1_generator, g2_generator
from zklaim_tpu_torch.ff import montgomery as TM
from zklaim_tpu_torch.ff.limbs import ints_to_limbs
from zklaim_tpu_torch.ff.params import MONT_R, Q, R
from zklaim_tpu_torch.kernels import cases as KC
from zklaim_tpu_torch.msm import gpu_msm as GM
from zklaim_tpu_torch.msm import pippenger as TP

# The suite runs as several worker processes on a few cores; torch's
# intra-op threads would only contend with them.
torch.set_num_threads(1)

SPECS = [(JM.FQ, TM.FQ), (JM.FR, TM.FR)]
IDS = ["Fq", "Fr"]
CSRC = Path(TM.__file__).parent.parent / "csrc"


@pytest.fixture(autouse=True)
def no_launches():
    """Nothing here may launch a kernel: every tensor lies on the CPU."""
    K.reset_launches()
    yield
    assert not any(K.LAUNCHES.values()), K.LAUNCHES


def _bits(e: int, width: int) -> np.ndarray:
    return np.array([(e >> i) & 1 for i in range(width)], dtype=np.uint32)


def _elements(p: int, seed: int, n: int = 12) -> list:
    rnd = random.Random(seed)
    return [0, 1, p - 1, p - 2] + [rnd.randrange(p) for _ in range(n - 4)]


# ---------------------------------------------------------------------------
# mont_pow_bits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
@pytest.mark.parametrize("exponent", [0, 1, 2, 0xB5, 0x9E3779, 0xFFFFFF, 0x800001])
def test_mont_pow_bits_matches_jax_and_python_pow(specs, exponent):
    """Exponents of up to 24 bits, all given as 24 bits (one XLA compile of
    the reference's loop a field); 0 and p - 1 among the inputs."""
    jspec, tspec = specs
    width = 24
    vals = _elements(tspec.p, exponent + width)
    a = TM.encode_ints(tspec, vals)                     # Montgomery form, 0 among the inputs
    bits = _bits(exponent, width)
    got = TM.mont_pow_bits(tspec, torch.from_numpy(a.astype(np.int32)), bits)
    want = JM.mont_pow_bits(jspec, jnp.asarray(a), bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int32))
    assert TM.decode_ints(tspec, got) == [pow(v, exponent, tspec.p) for v in vals]
    assert torch.equal(got, TM.mont_pow_bits_plain(tspec, torch.from_numpy(a.astype(np.int32)), bits))


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
def test_mont_inv_is_the_fermat_power(specs):
    _, tspec = specs
    vals = _elements(tspec.p, 77, 6)
    a = torch.from_numpy(TM.encode_ints(tspec, vals).astype(np.int32))
    got = TM.decode_ints(tspec, TM.mont_inv(tspec, a))
    assert got == [pow(v, tspec.p - 2, tspec.p) for v in vals]
    assert got[0] == 0 and got[1] == 1                  # 0 -> 0
    batched = TM.mont_pow_bits(tspec, a.view(2, 3, 16), tspec.exp_p_minus_2_bits)
    assert TM.decode_ints(tspec, batched) == got        # any batch shape


@pytest.mark.parametrize("e", [0, 1, 5, (1 << 32) - 1, 1 << 32, Q - 2, R - 2, (1 << 256) - 1])
def test_pack_exponent_round_trip(e):
    words, nbits = TM.pack_exponent(_bits(e, 256))
    assert nbits == e.bit_length() and len(words) == 8
    assert sum(w << (32 * j) for j, w in enumerate(words)) == e
    assert all(0 <= w < 1 << 32 for w in words)
    short = TM.pack_exponent(_bits(e, max(1, e.bit_length())))      # no padding needed
    assert short == (words, nbits)


def test_pack_exponent_rejects_what_the_kernel_cannot_take():
    assert TM.pack_exponent([]) == ([0] * 8, 0)
    assert TM.pack_exponent(np.zeros(256, dtype=np.uint32)) == ([0] * 8, 0)
    with pytest.raises(ValueError, match="256"):
        TM.pack_exponent(np.ones(257, dtype=np.uint32))
    with pytest.raises(ValueError, match="0 or 1"):
        TM.pack_exponent([0, 2, 1])
    a = torch.zeros((2, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="256"):        # the same limit on the CPU
        TM.mont_pow_bits(TM.FQ, a, np.ones(257, dtype=np.uint32))


def test_kernel_wrappers_take_no_cpu_tensor():
    """The wrappers launch or raise: a CPU tensor never reaches a plain
    version through them (only the dispatchers choose by device)."""
    a = torch.zeros((2, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        TM.mont_pow_k1(TM.FQ, a, [1, 0, 1])
    p = C.infinity_planes(1, 16, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        GM.msm_finish_planes(1, p, p, 16, 1)


# ---------------------------------------------------------------------------
# the schedule the kernel msm_finish interprets
# ---------------------------------------------------------------------------

GROUPS = [(1, g1_generator), (2, g2_generator)]


def _raw(t: torch.Tensor) -> list:
    """(n, 16) limbs -> the integers they spell (Montgomery form left as is)."""
    rows = t.numpy().astype("<u2").reshape(-1, 16)
    return [int.from_bytes(r.tobytes(), "little") for r in rows]


def _components(deg: int, pt) -> list:
    """Point tuple with batch (n,) -> per lane the 3 deg Fq components in
    plane order (x0, x1, y0, y1, z0, z1)."""
    n = pt[0].shape[0]
    cols = [_raw(c.reshape(n, deg, 16)[:, j]) for c in pt for j in range(deg)]
    return [[col[i] for col in cols] for i in range(n)]


def _plane_components(planes: torch.Tensor) -> list:
    """(3 deg, 16, n) planes -> per lane its 3 deg components."""
    cols = [_raw(plane.t().contiguous()) for plane in planes]
    return [[col[i] for col in cols] for i in range(planes.shape[2])]


def _test_points(deg, gen, seed, n=6):
    """Two batches p, q with Z != 1: lane 1 of p and lane 2 of q infinity,
    lane 3 p = 2 q, lane 4 p = -2 q."""
    f = C.ops_for(deg, plain=True)
    rnd = random.Random(seed)
    g = gen()
    hp = [g * rnd.randrange(1, R) for _ in range(n)]
    hq = [g * rnd.randrange(1, R) for _ in range(n)]
    hp[1] = hq[2] = g.infinity(g.b)
    hq[3], hq[4] = hp[3], -hp[4]
    p = C.point_double(f, C.host_points_to_proj(f, hp, "cpu"))
    q = C.host_points_to_proj(f, hq, "cpu")
    return f, p, C.point_add(f, q, C.point_infinity(f, (n,), "cpu"))


def _file(sched, acc, addend=None) -> dict:
    file = dict(sched["consts"])
    file.update(zip(sched["acc"], acc))
    if addend is not None:
        file.update(zip(sched["addend"], addend))
    return file


@pytest.mark.parametrize("deg,gen", GROUPS, ids=["G1", "G2"])
def test_schedules_match_the_plain_formulas(deg, gen):
    """The doubling and the add, interpreted step by step as the kernel
    does, give curve.point_double and curve.point_add limb for limb, also
    when chained (the constants survive, slots are reused correctly)."""
    f, p, q = _test_points(deg, gen, 40 + deg)
    sched = S.finish_schedule(deg)
    P, Qs = _components(deg, p), _components(deg, q)
    doubled = _components(deg, C.point_double(f, p))
    summed = C.point_add(f, p, q)
    chained = _components(deg, C.point_double(f, C.point_double(f, summed)))
    summed = _components(deg, summed)
    for i in range(len(P)):
        file = _file(sched, P[i])
        S.interpret(sched["double"], file)
        assert [file[s] for s in sched["acc"]] == doubled[i], (i, "double")
        file = _file(sched, P[i], Qs[i])
        S.interpret(sched["add"], file)
        assert [file[s] for s in sched["acc"]] == summed[i], (i, "add")
        S.interpret(sched["double"], file)
        S.interpret(sched["double"], file)
        assert [file[s] for s in sched["acc"]] == chained[i], (i, "chained")


@pytest.mark.parametrize("deg", [1, 2], ids=["G1", "G2"])
def test_schedule_shape(deg):
    """What the kernel relies on: a step is all products or all linear, fits
    the group, and a round's products share a step (2 product steps a G1
    operation; 3 over Fq2, where the constant products take one)."""
    sched = S.finish_schedule(deg)
    assert sched["g"] == S.group_size(deg) <= 32 and sched["g"] >= 3 * deg
    assert sched["slots"] < S.IDLE
    for name in ("double", "add"):
        steps = sched[name]
        assert all(len({op == S.MUL for op, *_ in step}) == 1 for step in steps)
        assert all(0 < len(step) <= sched["g"] for step in steps)
        assert sum(step[0][0] == S.MUL for step in steps) == 1 + deg
        written = [d for step in steps for _, d, _, _ in step]
        assert set(sched["acc"]) <= set(written)
        assert not set(written) & set(sched["addend"])

    def products(steps):
        return sum(op == S.MUL for step in steps for op, *_ in step)

    assert products(sched["double"]) == {1: 8, 2: 8 * 4 + 2 * 4}[deg]
    assert products(sched["add"]) == {1: 12, 2: 12 * 4 + 2 * 4}[deg]


def _unpack(words: np.ndarray) -> dict:
    """Decode a packed schedule as csrc/curve.cu does."""
    w = [int(x) for x in words]
    g, ns, nconst, sdbl, sadd = (w[i] for i in (S.HDR_G, S.HDR_NS, S.HDR_NCONST, S.HDR_SDBL,
                                                S.HDR_SADD))
    at = S.HDR_WORDS
    consts = {}
    for _ in range(nconst):
        consts[w[at]] = sum(x << (32 * j) for j, x in enumerate(w[at + 1 : at + 9]))
        at += 9

    def steps(count):
        nonlocal at
        out = []
        for _ in range(count):
            row = [(e >> 24, (e >> 16) & 0xFF, e & 0xFF, (e >> 8) & 0xFF) for e in w[at : at + g]]
            out.append([r for r in row if r[1] != S.IDLE])
            at += g
        return out

    dbl, add = steps(sdbl), steps(sadd)
    assert at == len(w)
    return {"g": g, "slots": ns, "consts": consts, "double": dbl, "add": add,
            "acc": w[S.HDR_ACC : S.HDR_ACC + 6], "addend": w[S.HDR_Q : S.HDR_Q + 6]}


@pytest.mark.parametrize("deg", [1, 2], ids=["G1", "G2"])
def test_packed_schedule_decodes_to_the_schedule(deg):
    sched = S.finish_schedule(deg)
    words = S.pack(sched)
    assert words.dtype == np.uint32
    back = _unpack(words)
    for key in ("g", "slots", "consts", "double", "add"):
        assert back[key] == sched[key], key
    assert back["acc"][: 3 * deg] == sched["acc"] and back["addend"][: 3 * deg] == sched["addend"]
    used = [slot for step in back["double"] + back["add"] for _, d, a, b in step for slot in (d, a, b)]
    assert max(used) < back["slots"]


def test_pack_rejects_a_mixed_step():
    sched = dict(S.finish_schedule(1))
    sched["double"] = [[(S.MUL, 7, 0, 1), (S.ADD, 8, 0, 1)]] + list(sched["double"])
    with pytest.raises(ValueError, match="mixes"):
        S.pack(sched)


def test_schedule_offsets_match_the_cuda_source():
    """The header offsets, opcodes and limits that csrc/curve.cu and the
    Python side must agree on, and the Montgomery one of csrc/field.cuh."""
    src = (CSRC / "curve.cu").read_text()

    def define(name):
        text = re.search(rf"#define {name} +(0x[0-9a-f]+|[0-9]+)", src).group(1)
        return int(text, 0)

    pairs = {"FIN_G": S.HDR_G, "FIN_NS": S.HDR_NS, "FIN_NCONST": S.HDR_NCONST,
             "FIN_SDBL": S.HDR_SDBL, "FIN_SADD": S.HDR_SADD, "FIN_ACC": S.HDR_ACC,
             "FIN_Q": S.HDR_Q, "FIN_HDR": S.HDR_WORDS, "FIN_MUL": S.MUL, "FIN_ADD": S.ADD,
             "FIN_SUB": S.SUB, "FIN_IDLE": S.IDLE, "FIN_THREADS": 32 * GM.FINISH_MAX_WARPS}
    for name, value in pairs.items():
        assert define(name) == value, name
    assert re.search(r"#define FIN_SHARED_MAX \((\d+) \* 1024\)", src).group(1) == str(
        GM.FINISH_SHARED_BYTES // 1024)
    field = (CSRC / "field.cuh").read_text()
    body = re.search(r"ZK_ONE[^=]*=\s*\{(.*?)\};", field, re.S).group(1)
    ones = [int(h, 16) for h in re.findall(r"0x([0-9a-f]+)u", body)]
    assert ones == [(x >> (32 * i)) & 0xFFFFFFFF for x in (MONT_R % Q, MONT_R % R) for i in range(8)]


# ---------------------------------------------------------------------------
# the finish
# ---------------------------------------------------------------------------


def _partials(deg, gen, lanes, seed):
    """Window partials as host points and as planes: infinity, tot = head
    and tot = -head among the lanes, Z != 1."""
    f = C.ops_for(deg, plain=True)
    rnd = random.Random(seed)
    g = gen()
    tot = [g * rnd.randrange(1, R) for _ in range(lanes)]
    head = [g * rnd.randrange(1, R) for _ in range(lanes)]
    tot[1] = head[2] = head[5] = tot[5] = g.infinity(g.b)
    head[3], head[4] = tot[3], -tot[4]
    inf = C.point_infinity(f, (lanes,), "cpu")
    planes = [C.point_to_planes(f, C.point_add(f, C.host_points_to_proj(f, h, "cpu"), inf))
              for h in (tot, head)]
    return tot, head, planes[0], planes[1]


def _host_finish(tot, head, c, k):
    W = len(tot) // k
    out = []
    for i in range(k):
        acc = tot[0].infinity(tot[0].b)
        for w in range(W - 1, -1, -1):
            acc = acc * (1 << c) + (tot[i * W + w] * (1 << (c - 1)) + (-head[i * W + w]))
        out.append(acc)
    return out


def test_finish_plain_matches_jax_finish_per_sum():
    """G1, k = 2, c = 8: the port's finish of two sums side by side equals
    the JAX package's _finish of each sum alone, limb for limb, and the
    dispatcher on CPU planes is the plain version."""
    k, c, W = 2, 8, 32
    tot_h, head_h, tot, head = _partials(1, g1_generator, k * W, 31)
    got = GM.finish(1, tot, head, c, k)
    assert torch.equal(got, GM.finish_plain(1, tot, head, c, k))
    assert got.shape == (3, 16, k)

    def planes(t):                      # (3, 16, W) -> three (16, W) u32 planes
        return tuple(jnp.asarray(p.numpy().astype(np.uint32)) for p in t)

    for i in range(k):
        lanes = slice(i * W, (i + 1) * W)
        want = JP._finish(JC.FQ_OPS, planes(tot[..., lanes]), planes(head[..., lanes]), c)
        for g_, w in zip(C.planes_to_point(C.FQ_OPS, got[..., i : i + 1]), want):
            np.testing.assert_array_equal(g_.numpy()[0], np.asarray(w).astype(np.int32))
    assert C.planes_to_host_points(1, got) == _host_finish(tot_h, head_h, c, k)


@pytest.mark.parametrize("deg,gen,k", [(2, g2_generator, 1), (1, g1_generator, 4)],
                         ids=["G2-k1", "G1-k4"])
def test_finish_plain_matches_host_points(deg, gen, k):
    c, W = 16, 16
    tot_h, head_h, tot, head = _partials(deg, gen, k * W, 50 + deg)
    got = GM.finish(deg, tot, head, c, k)
    assert C.planes_to_host_points(deg, got) == _host_finish(tot_h, head_h, c, k)


@pytest.mark.parametrize("deg,gen,k,c", [(1, g1_generator, 2, 16), (2, g2_generator, 1, 16),
                                         (1, g1_generator, 1, 8)],
                         ids=["G1-k2-c16", "G2-k1-c16", "G1-k1-c8"])
def test_interpreted_finish_matches_finish_plain(deg, gen, k, c):
    """The kernel's two phases on Python integers -- the schedule, the lane
    order i W + w, the negated head, acc = infinity from the constants --
    give finish_plain's planes limb for limb."""
    _, _, tot, head = _partials(deg, gen, k * (256 // c), 60 + deg + c)
    want = _plane_components(GM.finish_plain(deg, tot, head, c, k))
    got = S.interpret_finish(S.finish_schedule(deg), _plane_components(tot),
                             _plane_components(head), c, k)
    assert got == want


def test_msm_many_end_to_end_unchanged():
    """Two G1 sums of different lengths through msm_many (flat batch, one
    finish of k = 2) equal the host sums; msm_pow2 gives the same planes as
    the batch's lane."""
    rnd = random.Random(5)
    g = g1_generator()
    f = C.FQ_OPS
    pairs, want = [], []
    for n in (8, 5):
        pts = [g * rnd.randrange(1, R) for _ in range(n)]
        pts[2] = g.infinity(g.b)
        sc = [rnd.randrange(R) for _ in range(n)]
        sc[1] = 0
        rows = C.planes_to_rows(C.point_to_planes(f, C.host_points_to_proj(f, pts, "cpu")))
        pairs.append((rows, torch.from_numpy(ints_to_limbs(sc).astype(np.int32))))
        acc = pts[0] * sc[0]
        for p_, s in zip(pts[1:], sc[1:]):
            acc = acc + p_ * s
        want.append(acc)
    got = TP.msm_many(1, pairs, 8)
    assert got.shape == (3, 16, 2)
    assert C.planes_to_host_points(1, got) == want
    assert C.planes_to_host_points(1, TP.msm_pow2(1, *pairs[1], 8)) == want[1:]


def test_loop_cases_build_on_the_cpu():
    """kernels.cases.loop_cases at a small size: kernel side and plain side
    agree (both plain here), and the stated work gives a bound by operations."""
    cases = KC.loop_cases("cpu", np.random.default_rng(2), n_pow=6, finishes=((1, 2, 16),))
    assert [c.kernel for c in cases] == ["mont_pow", "mont_pow", "msm_finish"]
    for case in cases:
        assert case.plain_once
        assert KC.max_abs_err(case.run(), case.plain()) == 0, case.label
        ms, by = KC.bound_ms(case)
        assert ms > 0 and by == "operations"
    pow_q, _, finish = cases
    assert pow_q.products == 6 * (253 + bin(Q - 2).count("1")) and pow_q.elements_moved == 12
    assert finish.products == 2 * 16 * ((15 + 16) * 8 + 2 * 12)
    assert finish.elements_moved == 3 * (2 * 32 + 2)
