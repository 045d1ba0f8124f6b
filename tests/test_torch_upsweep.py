"""The upsweep and the Abel tree of the port's MSM on the CPU:
msm.gpu_msm.upsweep and abel, kernels msm_upsweep and msm_abel on the
card (K4's third and fourth entries).

On CPU tensors the dispatchers run `upsweep_plain` and `abel_plain`, the
loops of the plain add over the halves.  Here the launch plan
(msm/upsweep_plan.py) is held to its contract -- every level built once, in
order, down to width 1, each launch within a CTA's shared memory and at
most four launches a pass of the credential path -- and the plan's
interpreter, which runs each launch CTA by CTA with the kernel's index
arithmetic, is held to the loops limb for limb (G1 and G2; a CTA's slots
cut small, `held`, so that a few hundred lanes make several launches of
several CTAs), and so is the Abel plan, also where a column's tree takes a
chain of launches.  Integer arithmetic throughout: tolerance 0.
"""

import re
from pathlib import Path

import numpy as np
import pytest

import torch

from zklaim_tpu_torch import kernels as K
from zklaim_tpu_torch.ec import gpu_curve as G
from zklaim_tpu_torch.kernels import cases as KC
from zklaim_tpu_torch.msm import gpu_msm as GM
from zklaim_tpu_torch.msm import upsweep_plan as UP

# The suite runs as several worker processes on a few cores; torch's
# intra-op threads would only contend with them.
torch.set_num_threads(1)

CSRC = Path(G.__file__).parent.parent / "csrc"


@pytest.fixture(autouse=True)
def no_launches():
    """Nothing here may launch a kernel: every tensor lies on the CPU."""
    K.reset_launches()
    yield
    assert not any(K.LAUNCHES.values()), K.LAUNCHES


def _hold(monkeypatch, held):
    """A CTA holds `held` points (None: the card's 48 KB), so that a small
    batch makes the plans of a large one."""
    if held is not None:
        monkeypatch.setattr(UP, "slots", lambda deg: held)


def _halves_loop(deg, planes, width):
    """Today's loop as the pipeline ran it before the kernels: the halves
    added by point_add_halves until `width` columns are left."""
    out = [planes]
    while out[-1].shape[-1] > width:
        out.append(G.point_add_halves(deg, out[-1]))
    return out


@pytest.mark.parametrize("deg", [1, 2])
@pytest.mark.parametrize("held", [None, 128, 32, 8])
def test_plan_covers_every_level_once(monkeypatch, deg, held):
    """For every batch of 2^nb lanes, nb = 0 ... 24: the launches build
    levels 1 ... nb each once and in order and end at width 1; a launch's
    CTAs hold 2^(r-1) T points at most what a CTA holds, own whole runs of T
    columns of its last level, and the last launch is one CTA."""
    _hold(monkeypatch, held)
    cap = UP.slots(deg)
    for nb in range(25):
        plan = UP.upsweep_plan(deg, nb)
        levels = [t + s for t, r, _ in plan for s in range(1, r + 1)]
        assert levels == list(range(1, nb + 1)), (nb, plan)
        for t, r, cols in plan:
            w_out = 1 << (nb - t - r)
            assert cols & (cols - 1) == 0 and w_out % cols == 0, (nb, plan)
            assert (1 << (r - 1)) * cols <= cap, (nb, plan)
        if nb:
            t, r, cols = plan[-1]
            assert t + r == nb and cols == 1, (nb, plan)


@pytest.mark.parametrize("deg,nb,rs", [(1, 21, [3, 5, 5, 8]), (2, 20, [3, 5, 5, 7]),
                                       (1, 15, [3, 5, 7]), (2, 15, [3, 5, 7])],
                         ids=["G1-2^21", "G2-2^20", "G1-2^15", "G2-2^15"])
def test_path_passes_take_at_most_four_launches(deg, nb, rs):
    """The credential path's passes (G1 2^21 lanes, G2 2^20) and the bench's
    2^10-point check (2^15) at the card's shared memory: at most four
    launches; the first a column a lane of a CTA, then runs of a warp's
    columns until one CTA holds the rest."""
    plan = UP.upsweep_plan(deg, nb)
    assert [r for _, r, _ in plan] == rs
    assert len(plan) <= 4
    assert ([cols for _, _, cols in plan]
            == [UP.THREADS // deg] + [UP.WARP // deg] * (len(plan) - 2) + [1])
    assert UP.slots(deg) == (512 if deg == 1 else 256)


@pytest.mark.parametrize("deg,lanes,held", [(1, 256, 16), (1, 512, 64), (1, 256, None),
                                            (1, 1024, 256), (2, 256, 32), (2, 128, None),
                                            (2, 512, 128)],
                         ids=["G1-256-tile16", "G1-512-tile64", "G1-256-card", "G1-1024-tile256",
                              "G2-256-tile32", "G2-128-card", "G2-512-tile128"])
def test_interpreted_upsweep_matches_the_loop(monkeypatch, deg, lanes, held):
    """The plan run launch by launch and CTA by CTA with the kernel's index
    arithmetic gives every level of the halving loop limb for limb, and so
    does the dispatcher on CPU planes."""
    _hold(monkeypatch, held)
    level0 = KC.random_points(deg, lanes, np.random.default_rng(lanes + deg), "cpu")
    want = _halves_loop(deg, level0, 1)
    plan = UP.upsweep_plan(deg, lanes.bit_length() - 1)
    assert len(plan) >= (2 if held else 1)
    got = UP.interpret_upsweep(deg, level0, plan)
    assert len(got) == len(want)
    for t, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), t
    assert all(torch.equal(g, w) for g, w in zip(GM.upsweep(deg, level0), want))


@pytest.mark.parametrize("deg,c,k", [(1, 4, 1), (1, 4, 4), (1, 8, 1), (1, 8, 4), (2, 4, 1),
                                     (2, 8, 1)])
def test_interpreted_abel_matches_the_halving_loop(deg, c, k):
    """The Abel tree, heads (3 deg, 16, B k W) halved to k W columns, as
    kernel msm_abel runs it (one launch, one CTA a column, the inner levels
    in shared memory) equals the pipeline's halving loop, and so does the
    dispatcher on CPU planes."""
    kw, B = k * 256 // c, 1 << (c - 1)
    heads = KC.random_points(deg, B * kw, np.random.default_rng(10 * c + k), "cpu")
    want = _halves_loop(deg, heads, kw)[-1]
    assert UP.abel_plan(deg, B * kw, kw) == [c - 1]
    assert torch.equal(UP.interpret_abel(deg, heads, kw), want)
    assert torch.equal(GM.abel(deg, heads, kw), want)


@pytest.mark.parametrize("deg,levels,kw,held,plan", [(1, 11, 2, None, [6, 5]),
                                                     (2, 10, 2, None, [5, 5]),
                                                     (1, 7, 4, 8, [4, 3]),
                                                     (2, 9, 2, 2, [2, 2, 2, 2, 1])],
                         ids=["G1-11-card", "G2-10-card", "G1-7-tile8", "G2-9-tile2"])
def test_interpreted_abel_chains_a_tree_past_one_cta(monkeypatch, deg, levels, kw, held, plan):
    """A column's tree taller than a CTA holds (G1 past 10 levels, G2 past
    9, or a small `held`) runs as a chain of launches, each launch's columns
    the next one's heads: interpreted so, it equals the halving loop."""
    _hold(monkeypatch, held)
    heads = KC.random_points(deg, kw << levels, np.random.default_rng(levels + deg), "cpu")
    assert UP.abel_plan(deg, heads.shape[-1], kw) == plan
    assert torch.equal(UP.interpret_abel(deg, heads, kw), _halves_loop(deg, heads, kw)[-1])


def test_abel_plan_chains_a_tree_a_cta_cannot_hold():
    """c = 16 holds 2^15 heads a window: more than a CTA's shared memory, so
    the tree takes two launches of 8 and 7 levels, G1 and G2; a tree
    a CTA holds takes one; heads that do not halve to the columns are
    refused."""
    assert UP.abel_plan(1, 512 << 10, 512) == [10] and UP.abel_plan(2, 32 << 9, 32) == [9]
    assert UP.abel_plan(1, 16 << 11, 16) == [6, 5] and UP.abel_plan(2, 16 << 10, 16) == [5, 5]
    assert UP.abel_plan(1, 64 << 15, 64) == [8, 7] and UP.abel_plan(2, 16 << 15, 16) == [8, 7]
    assert UP.abel_plan(1, 16, 16) == []
    with pytest.raises(ValueError, match="halve"):
        UP.abel_plan(1, 48, 16)


def test_upsweep_and_abel_wrappers_take_no_cpu_tensor():
    """The wrappers launch or raise: CPU planes reach the plain versions only
    through the dispatchers."""
    level0 = KC.random_points(1, 64, np.random.default_rng(3), "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        GM.msm_upsweep_planes(1, level0, UP.upsweep_plan(1, 6))
    with pytest.raises(ValueError, match="CUDA"):
        GM.msm_abel_planes(1, level0, 16, [2])


def test_upsweep_cases_build_on_the_cpu():
    """kernels.cases.upsweep_cases at a small size: kernel side and plain side
    agree (both plain here); the work reads level 0 once and writes every
    level once."""
    cases = KC.upsweep_cases("cpu", np.random.default_rng(4), passes=((1, 1, 4, 64),
                                                                      (2, 1, 4, 32)))
    assert [c.kernel for c in cases] == ["msm_upsweep", "msm_upsweep", "msm_abel", "msm_abel"]
    for case, deg, n in zip(cases, (1, 2, 1, 2), (64, 32, 8 * 64, 8 * 64)):
        assert case.plain_once
        assert KC.max_abs_err(case.run(), case.plain()) == 0, case.label
        if case.kernel == "msm_upsweep":
            assert case.elements_moved == 3 * deg * (2 * n - 1)
            assert case.products == KC.ADD_PRODUCTS[deg] * (n - 1)
        else:
            assert case.elements_moved == 3 * deg * (n + 64)
            assert case.products == KC.ADD_PRODUCTS[deg] * (n - 64)
        assert KC.bound_ms(case)[0] > 0


def test_upsweep_constants_match_the_cuda_sources():
    """The limits the plan and csrc/curve.cu must agree on."""
    curve = (CSRC / "curve.cu").read_text()
    assert int(re.search(r"#define UPS_THREADS (\d+)", curve).group(1)) == UP.THREADS
    kib = int(re.search(r"#define UPS_SHARED_MAX \((\d+) \* 1024\)", curve).group(1))
    assert kib * 1024 == UP.SHARED_BYTES
    assert "return b0 + (x & (T - 1)) + (int64_t)(x / T) * w_out;" in curve


def test_upsweep_tools_need_a_card_and_read_their_runs():
    """tools/msm_stages.py's launch-by-launch upsweep refuses the CPU;
    tools/kernel_ab.py's pass table reads each run's pass stages and warm
    proves."""
    from zklaim_tpu_torch.tools import kernel_ab, msm_stages

    with pytest.raises(ValueError, match="card"):
        msm_stages.upsweep_launches("cpu", 1, 10)
    stages = [{"deg": deg, "stage": s, "ms": 0.5 * deg} for deg in (1, 2)
              for s in ("digits", "sort", "gather", "upsweep", "tails", "abel", "finish")]
    proves = [{"group": f"prove {i}", "phase": p, "ms": ms} for i in (0, 1)
              for p, ms in (("five sums (4 G1 batched, G2)", 900.0), ("TOTAL", 1000.0 + i))]
    lines = kernel_ab.pass_rows({"0:other": {"stages": stages, "prove": proves},
                                 "1:this": {"stages": stages, "prove": proves}})
    assert len(lines) == 2 and lines[0].startswith("0:other") and lines[1].startswith("1:this")
    assert "upsweep 0.500 abel 0.500 all 3.500 ms" in lines[0]
    assert lines[1].endswith("warm prove at N = 20 least 1000.0, median 1001.0 ms")
