"""The plain versions of the probe kernels K6-K9 against the JAX package's
in-kernel arithmetic and the host oracles.

The JAX probes (tools/*_micro.py) launch on a TPU while they are imported,
so they are not imported here: their kernel bodies are re-run eagerly from
the same functions they call (pallas_field.mont_mul, pallas_curve._rcb_add
with _Fq), which are plain jnp code, and K7's four expressions
(tools/pallas_op_micro.py:18-25) are written out in numpy uint32 / float32.
The port's probes draw residues below p and points on the curve; on those
inputs the two packages agree limb for limb from the first step on.

Tolerance 0 everywhere.  f32fma's plain version is held bit for bit to a
fused multiply-add computed exactly (Python fractions, one rounding a step:
what the card's kernel computes), and beside that, element by element, to
the original's float32 expression, which rounds twice a step: within
K ulps, stated as a relative K * 2^-23.
"""

import re
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from zklaim_tpu.ec import pallas_curve as PC
from zklaim_tpu.ff import pallas_field as PF

from zklaim_tpu_torch.ec import curve as C
from zklaim_tpu_torch.ec.gpu_curve import point_add_plain
from zklaim_tpu_torch.ff.montgomery import FQ
from zklaim_tpu_torch.ff.params import Q
from zklaim_tpu_torch.kernels import KERNELS, PROBE_KERNELS
from zklaim_tpu_torch.kernels.cases import (
    LANE_CLOCKS_PER_S, bound_ms, curve_inputs, max_abs_err, probe_cases, random_field, random_points,
)
from zklaim_tpu_torch.tools import grid_micro, mont_micro, padd_micro, pallas_op_micro

torch.set_num_threads(1)

MONT_R = 1 << 256


def _jnp(planes: torch.Tensor):
    return jnp.asarray(planes.numpy().astype(np.uint32))


@pytest.mark.parametrize("k", [0, 1, 5])
def test_mont_chain_plain_matches_pallas_field_and_host(k):
    x = random_field(FQ, 8, np.random.default_rng(k), "cpu").t().contiguous()     # (16, 8)
    got = mont_micro.mont_chain(x, k)                  # a CPU tensor: the plain version
    assert torch.equal(got, mont_micro.mont_chain_plain(x, k))

    v = _jnp(x)
    for _ in range(k):
        v = PF.mont_mul(v, v, jnp.asarray(PF.FQ_P), jnp.asarray(PF.FQ_NP))
    np.testing.assert_array_equal(got.numpy(), np.asarray(v).astype(np.int32))

    # x holds a R: after k squarings a^(2^k) R, so the raw value is
    # x^(2^k) R^(1 - 2^k) mod p
    r_inv = pow(MONT_R, -1, Q)
    raw_in = [sum(int(l) << (16 * j) for j, l in enumerate(col)) for col in x.t().tolist()]
    raw_out = [sum(int(l) << (16 * j) for j, l in enumerate(col)) for col in got.t().tolist()]
    for a, b in zip(raw_in, raw_out):
        assert b == pow(a, 1 << k, Q) * pow(r_inv, (1 << k) - 1, Q) % Q


@pytest.mark.parametrize("k", [1, 3])
def test_point_add_chain_plain_matches_rcb_add_and_host(k):
    p = random_points(1, 8, np.random.default_rng(10 + k), "cpu", pool=6)      # (3, 16, 8)
    got = padd_micro.point_add_chain(p, k)
    assert torch.equal(got, padd_micro.point_add_chain_plain(p, k))

    f = PC._Fq(jnp.asarray(PF.FQ_P), jnp.asarray(PF.FQ_NP))
    pt = tuple(_jnp(c) for c in p)
    for _ in range(k):
        pt = PC._rcb_add(f, pt, pt)
    np.testing.assert_array_equal(got.numpy(), np.stack([np.asarray(c) for c in pt]).astype(np.int32))

    host_in = C.planes_to_host_points(1, p)
    assert C.planes_to_host_points(1, got) == [q * (1 << k) for q in host_in]
    assert any(q.inf for q in host_in)                 # infinity is among the lanes


def test_point_add_chain_of_zero_steps_is_a_copy():
    p = random_points(1, 4, np.random.default_rng(3), "cpu", pool=4)
    out = padd_micro.point_add_chain(p, 0)
    assert torch.equal(out, p) and out.data_ptr() != p.data_ptr()


@pytest.mark.parametrize("tile", [1, 3, 8, 16, 64])
def test_point_add_tiled_plain_is_point_add_for_every_tile(tile):
    p, q = curve_inputs(1, 16, np.random.default_rng(7), "cpu")
    want = point_add_plain(1, p, q)
    assert torch.equal(grid_micro.point_add_tiled(p, q, tile), want)
    with pytest.raises(ValueError):
        grid_micro.point_add_tiled_plain(p, q, 0)


def _probes_define(name: str) -> int:
    src = (Path(grid_micro.__file__).resolve().parent.parent / "csrc" / "probes.cu").read_text()
    assert f"__launch_bounds__({name})" in src
    return int(re.search(rf"#define {name} (\d+)", src).group(1))


def _tiled_walk(n: int, tile: int, threads: int):
    """The lanes csrc/probes.cu's point_add_tiled_kernel adds, in the order
    its CTAs, threads and steps name them: CTA c, thread t takes lanes
    c tile + t, c tile + t + threads, ... below (c + 1) tile and below n."""
    for cta in range(-(-n // tile)):
        for t in range(threads):
            for j in range(t, tile, threads):
                if cta * tile + j >= n:
                    break
                yield cta * tile + j


@pytest.mark.parametrize("tile", grid_micro.TILES)
def test_point_add_tiled_threads_cover_every_lane_once(tile):
    """K8's geometry as the wrapper picks it: a tile's CTA has min(tile, 384)
    threads -- 384 is csrc/probes.cu's TILED_MAX_THREADS, its
    __launch_bounds__ -- and the kernel's walk (CTA, thread, step) names
    each lane once on the probe's n and on ragged ones; the plain version
    is still point_add_plain at every tile."""
    assert grid_micro.TILED_MAX_THREADS == _probes_define("TILED_MAX_THREADS") == 384
    threads = grid_micro.tiled_threads(tile)
    assert threads == min(tile, 384)
    for n in (grid_micro.N, grid_micro.N + 77, 1000, 129):
        lanes = list(_tiled_walk(n, tile, threads))
        assert len(lanes) == n and sorted(lanes) == list(range(n)), (n, tile)
    p, q = curve_inputs(1, 37, np.random.default_rng(tile), "cpu")
    assert torch.equal(grid_micro.point_add_tiled(p, q, tile), point_add_plain(1, p, q))
    with pytest.raises(ValueError):
        grid_micro.tiled_threads(0)


def test_point_add_chain_threads_spread_lanes_over_the_sms():
    """K9's CTA size: 1,024 lanes on 132 SMs go to 32 CTAs of one warp (one
    a SM); the card-filling width to CTAs of CHAIN_MAX_THREADS (csrc/
    probes.cu, its __launch_bounds__); a CTA is whole warps, and the CTAs
    never outnumber the SMs while a CTA is below the cap."""
    assert padd_micro.CHAIN_MAX_THREADS == _probes_define("CHAIN_MAX_THREADS") == 256
    assert padd_micro.chain_threads(padd_micro.LANES, 132) == 32
    assert padd_micro.chain_threads(padd_micro.WIDE_LANES, 132) == 256
    for n in (1, 31, 33, 1024, 4224, 4225, 30000, 1 << 20):
        t = padd_micro.chain_threads(n, 132)
        assert t % 32 == 0 and 32 <= t <= 256, n
        if t < 256:
            assert -(-n // t) <= 132, n


def test_chain_threads_is_one_rule_with_the_cap_as_a_parameter():
    """K9's CTA size (padd_micro.chain_threads) and K6's (mont_micro.
    chain_threads) are one rule, padd_micro.chain_threads, at their own caps,
    each the __launch_bounds__ of its kernel in csrc/probes.cu."""
    assert mont_micro.CHAIN_MAX_THREADS == _probes_define("MONT_CHAIN_MAX_THREADS") == 256
    for n in (1, 33, 1024, 4225, 1 << 20):
        assert padd_micro.chain_threads(n, 132) == padd_micro.chain_threads(n, 132, 256)
        assert mont_micro.chain_threads(n, 132) == padd_micro.chain_threads(n, 132, 256)
    assert padd_micro.chain_threads(1 << 20, 132, 128) == 128
    assert padd_micro.chain_threads(4225, 132, 64) == 64


@pytest.mark.parametrize("n", [1, 31, 33, 1023, 1024, 1101, 4224, 20000, 1 << 20,
                               1081344, 1081344 + 77])
def test_mont_chain_plan_spreads_lanes_over_the_sms(n):
    """K6's launch: 1,024 lanes on 132 SMs go to 32 CTAs of one warp, one an
    SM; the card-filling width to 4,224 CTAs of 256 threads (8 an SM, every
    warp an SM holds at the kernel's 32 registers).  On 1, 7, 114 and 132
    SMs a CTA is whole warps, while a CTA is below the cap the CTAs never
    outnumber the SMs, and the kernel's walk -- CTA c, thread t runs lane
    c threads + t where that is below n, in zk_mont_chain's ceil(n /
    threads) CTAs -- names every lane exactly once: part-full last CTAs and
    CTAs of one warp included."""
    assert mont_micro.chain_threads(mont_micro.LANES, 132) == 32
    assert mont_micro.chain_threads(mont_micro.WIDE_LANES, 132) == 256
    assert mont_micro.WIDE_LANES // 256 == 4224 == 8 * 132 * 4
    for sms in (1, 7, 114, 132):
        threads = mont_micro.chain_threads(n, sms)
        ctas = -(-n // threads)
        assert threads % 32 == 0 and 32 <= threads <= 256, (n, sms)
        if threads < 256:
            assert ctas <= sms, (n, sms)
        lanes = (np.arange(ctas)[:, None] * threads + np.arange(threads)).ravel()
        lanes = lanes[lanes < n]
        assert len(lanes) == n and (np.bincount(lanes, minlength=n) == 1).all(), (n, sms)


def _numpy_op(op: str, v: np.ndarray, k: int) -> np.ndarray:
    """tools/pallas_op_micro.py:18-25 in numpy, k steps."""
    with np.errstate(over="ignore"):
        for _ in range(k):
            if op == "u32mul":
                v = v * (v | np.uint32(1))
            elif op == "u32add":
                v = v + (v ^ np.uint32(12345))
            elif op == "f32fma":
                v = v * np.float32(1.0000001) + np.float32(0.5)
            elif op == "u16mul":
                v = (v & np.uint32(0xFFFF)) * np.uint32(3)
    return v


@pytest.mark.parametrize("k", [1, 7, 64])
@pytest.mark.parametrize("op", pallas_op_micro.OPS)
def test_op_chain_plain_matches_numpy(op, k):
    x = pallas_op_micro.probe_input(op, 96, "cpu", seed=k)
    if op != "f32fma":
        # also bit patterns with the top bit set, where int32 and uint32 part
        x[0, :4] = torch.tensor([-1, -2147483648, 0x7FFFFFFF, -12345], dtype=torch.int32)
    got = pallas_op_micro.op_chain(op, x, k)
    assert got.dtype == x.dtype and got.shape == x.shape
    if op == "f32fma":
        want = _numpy_op(op, x.numpy().copy(), k)
        assert want.dtype == np.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=k * 2.0 ** -23, atol=0)
        # a fused step, exactly: v a + b as a fraction, rounded once to float32
        a, b = Fraction(float(np.float32(1.0000001))), Fraction(1, 2)
        for col in range(0, 96, 7):
            v = Fraction(float(x[3, col]))
            for _ in range(k):
                v = Fraction(float(np.float32(float(v * a + b))))
                assert v * a + b == Fraction(float(v * a + b))      # float64 holds it exactly
            assert float(got[3, col]) == float(v)
    else:
        want = _numpy_op(op, x.numpy().view(np.uint32).copy(), k)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_op_chain_rejects_wrong_types():
    x = pallas_op_micro.probe_input("u32mul", 8, "cpu")
    with pytest.raises(ValueError):
        pallas_op_micro.op_chain("f32fma", x, 1)
    with pytest.raises(ValueError):
        pallas_op_micro.op_chain("u32mul", x.float(), 1)
    with pytest.raises(ValueError):
        pallas_op_micro.op_chain("u64mul", x, 1)


def test_probe_cases_cover_k6_to_k9_and_agree_on_the_cpu():
    """The case list chip_smoke.py and the card tests run, rehearsed on the
    CPU (both sides are then the plain version): every probe kernel has a
    case, each is bound to its own inputs, and the bound is positive; K6
    also on ragged lane counts on both sides of its plans."""
    cases = probe_cases("cpu", np.random.default_rng(0), k_mont=2, k_op=3, k_op_long=4, k_add=1,
                        n_tiled=16, wide_lanes=24, n_ragged=21)
    assert [c.label for c in cases if c.kernel == "mont_chain"] == [
        "K6 mont_chain Fq lanes=1024 K=2", "K6 mont_chain Fq lanes=24 K=2",
        "K6 mont_chain Fq lanes=1023 K=3 (ragged)", "K6 mont_chain Fq lanes=1101 K=3 (ragged)",
        "K6 mont_chain Fq lanes=101 K=3 (ragged)"]
    assert {c.kernel for c in cases} == set(PROBE_KERNELS) <= set(KERNELS)
    labels = [c.label for c in cases]
    assert len(set(labels)) == len(labels)
    for case in cases:
        got, want = case.run(), case.plain()
        assert max_abs_err(got, want) == 0, case.label
        ms, by = bound_ms(case)
        assert ms > 0 and by in ("bytes", "operations")
    # a chain of k products is bound by operations, not by its 128 bytes a lane
    long_chain = probe_cases("cpu", np.random.default_rng(0), k_mont=512, k_op_long=1, n_tiled=16,
                             wide_lanes=8, n_ragged=9)[0]
    assert bound_ms(long_chain)[1] == "operations"
    assert bound_ms(long_chain, mad_per_s=1e12)[0] > bound_ms(long_chain)[0]
    # K7 at the probe's own length counts operations over the rate the lanes start them at:
    # two a step for the integer ops, one for f32fma
    k, n = pallas_op_micro.CHAIN[1], pallas_op_micro.ROWS * pallas_op_micro.COLS
    by_op = {c.label.split()[2]: c for c in probe_cases("cpu", np.random.default_rng(0), k_mont=1,
                                                        k_op=k, k_op_long=1, n_tiled=16,
                                                        wide_lanes=8, n_ragged=9)
             if c.kernel == "op_chain" and c.label.endswith(f"K={k}")}
    for op, per_step in (("u32mul", 2), ("u32add", 2), ("u16mul", 2), ("f32fma", 1)):
        assert bound_ms(by_op[op]) == (per_step * k * n / LANE_CLOCKS_PER_S * 1e3, "operations"), op


def test_probe_cases_time_k7_at_its_working_chain_length_first():
    """K7's first four cases -- chip_smoke.py's headline is a kernel's first
    case -- run the four ops at the tool's chain length (here a small one
    passed in; by default pallas_op_micro.CHAIN[0] = 20,000) on the original's
    (16, 8192), their plain versions run once, and each is bound by
    operations: at 20,000 steps 0.1565 ms for an integer op and 0.07825 for
    f32fma.  The K = 16 cases follow on the same inputs."""
    cases = [c for c in probe_cases("cpu", np.random.default_rng(0), k_mont=1, k_op=3, k_op_long=5,
                                    n_tiled=16, wide_lanes=8, n_ragged=9)
             if c.kernel == "op_chain"]
    ops = ["u32mul", "u32add", "u16mul", "f32fma"]
    assert [c.label for c in cases] == (
        [f"K7 op_chain {op} (16, 8192) K=5" for op in ops]
        + [f"K7 op_chain {op} (16, 8192) K=3" for op in ops])
    assert [c.plain_once for c in cases] == [True] * 4 + [False] * 4
    for long, short in zip(cases[:4], cases[4:]):
        assert long.ops * 3 == short.ops * 5 and long.extra_bytes == short.extra_bytes
        assert max_abs_err(long.run(), long.plain()) == 0, long.label
    n = pallas_op_micro.ROWS * pallas_op_micro.COLS
    default = [c for c in probe_cases("cpu", np.random.default_rng(0), k_mont=1, k_op=3,
                                      n_tiled=16, wide_lanes=8, n_ragged=9)
               if c.kernel == "op_chain"][:4]
    for case, op in zip(default, ops):
        assert case.label == f"K7 op_chain {op} (16, 8192) K={pallas_op_micro.CHAIN[0]}"
        want = (1 if op == "f32fma" else 2) * 20000 * n / LANE_CLOCKS_PER_S * 1e3
        assert bound_ms(case) == (want, "operations")
        assert want == pytest.approx(0.07825 if op == "f32fma" else 0.15650, abs=1e-5)


@pytest.mark.parametrize("tool", [mont_micro, pallas_op_micro, padd_micro])
def test_measure_on_the_cpu_names_the_cpu(tool):
    """A CPU drive of a probe says "cpu" on every row: no device metric."""
    rows = tool.measure("cpu", widths=(16,))
    assert rows and all(r["device"] == "cpu" and r["kernel"] in PROBE_KERNELS for r in rows)
    assert all("cpu" in tool.format_row(r) for r in rows)


def test_grid_micro_measure_on_the_cpu():
    rows = grid_micro.measure("cpu", 16, tiles=(4, 16, 64))
    assert [r["tile"] for r in rows] == [4, 16]        # tiles above n collapse to n
    assert [r["ctas"] for r in rows] == [4, 1]
    assert all(r["device"] == "cpu" for r in rows)
