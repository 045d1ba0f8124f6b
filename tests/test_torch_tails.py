"""The bucket-tail stage of the port's MSM on the CPU: msm.gpu_msm.tails,
kernel msm_tails on the card (K4's second entry).

On CPU tensors the dispatcher runs `tails_plain`, the JAX package's loop (a
plain add and a select a level).  Here it is held to that loop as the JAX
package runs it (its own helpers and its add, jitted once), the kernel's
lane walk (ec.rcb_schedule.tail_walk: the set bits of m lowest first, the
clamp, the reversal by __brevll and a shift) is held to the reads of
`tails_plain` for every prefix length of a batch, and the add-only schedule
the kernel runs is interpreted on Python integers along each lane's walk and
held to `tails_plain`'s planes.  Integer arithmetic throughout: tolerance 0.
Sizes are small: c = 4 passes of 64 to 256 lanes.
"""

import re
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from zklaim_tpu.ec import jaxcurve as JC
from zklaim_tpu.msm import pippenger as JP

from zklaim_tpu_torch import kernels as K
from zklaim_tpu_torch.ec import rcb_schedule as S
from zklaim_tpu_torch.kernels import cases as KC
from zklaim_tpu_torch.msm import gpu_msm as GM
from zklaim_tpu_torch.ntt import gpu_ntt

# The suite runs as several worker processes on a few cores; torch's
# intra-op threads would only contend with them.
torch.set_num_threads(1)

CSRC = Path(GM.__file__).parent.parent / "csrc"


@pytest.fixture(autouse=True)
def no_launches():
    """Nothing here may launch a kernel: every tensor lies on the CPU."""
    K.reset_launches()
    yield
    assert not any(K.LAUNCHES.values()), K.LAUNCHES


def _raw(t: torch.Tensor) -> list:
    """(n, 16) limbs -> the integers they spell (Montgomery form left as is)."""
    rows = t.numpy().astype("<u2").reshape(-1, 16)
    return [int.from_bytes(r.tobytes(), "little") for r in rows]


def _plane_components(planes: torch.Tensor) -> list:
    """(3 deg, 16, n) planes -> per lane its 3 deg components."""
    cols = [_raw(plane.t().contiguous()) for plane in planes]
    return [[col[i] for col in cols] for i in range(planes.shape[2])]


def _pass(deg, k, lanes, seed, c=4):
    return KC.tail_inputs(deg, k, c, lanes, np.random.default_rng(seed), "cpu")


@pytest.mark.parametrize("nb", range(4, 13))
def test_kernel_walk_reads_what_tails_plain_reads(nb):
    """Every prefix length 0 .. 2^nb of a batch of 2^nb lanes (and a few
    with bits above nb, which name no level): the kernel's walk reads
    exactly the (level, column) pairs that tails_plain adds, level by level
    in the same order."""
    m = list(range((1 << nb) + 1)) + [(1 << (nb + 1)) + 5, (3 << nb) | 6]
    mt = torch.tensor(m, dtype=torch.int64)
    plain = [[] for _ in m]
    for t in range(nb + 1):
        bit, store = GM._tail_nodes(mt, nb, t)
        for i in torch.nonzero(bit).flatten().tolist():
            plain[i].append((t, int(store[i])))
    for i, mi in enumerate(m):
        walk = S.tail_walk(mi, nb)
        assert walk == plain[i], (mi, walk, plain[i])
        assert all(0 <= col < 1 << (nb - t) for t, col in walk)
        assert len(walk) == bin(mi & ((2 << nb) - 1)).count("1")


@pytest.mark.parametrize("deg,k,lanes", [(1, 1, 64), (1, 4, 256), (2, 1, 64)],
                         ids=["G1-k1", "G1-k4", "G2-k1"])
def test_interpreted_tails_match_tails_plain(deg, k, lanes):
    """The add-only schedule, run on Python integers along each lane's walk
    as the kernel runs it (acc = infinity from the constants, one add a set
    bit), gives tails_plain's planes limb for limb."""
    levels, m, nb = _pass(deg, k, lanes, 10 * deg + k)
    want = _plane_components(GM.tails_plain(deg, levels, m, nb))
    got = S.interpret_tails(S.tails_schedule(deg), [_plane_components(lv) for lv in levels],
                            m.tolist(), nb)
    assert got == want


def test_tails_plain_matches_the_jax_tail_loop():
    """G1, k = 2: tails_plain on a pass's levels equals the JAX package's
    tail loop (msm/pippenger.py, the loop after the searchsorted) run with
    its own helpers on the same levels and prefix lengths, limb for limb,
    and the dispatcher on CPU planes is the plain version."""
    levels, m, nb = _pass(1, 2, 128, 7)
    got = GM.tails(1, levels, m, nb)
    assert torch.equal(got, GM.tails_plain(1, levels, m, nb))

    add = jax.jit(JP._plane_add(JC.FQ_OPS))
    jm = jnp.asarray(m.numpy().astype(np.int32))
    acc = JP._plane_infinity(JC.FQ_OPS, jm.shape[0])
    for t, lvl in enumerate(levels):
        jl = tuple(jnp.asarray(p.numpy().astype(np.uint32)) for p in lvl)
        wt = max(1, (1 << nb) >> t)
        nat = jnp.clip((jm >> t) - 1, 0, wt - 1)
        store = JP._revbits_dyn(nat, nb - t) if nb - t > 0 else nat
        node = JP._plane_take(jl, store)
        bit = ((jm >> t) & 1) == 1
        acc = JP._plane_select(bit, add(acc, node), acc)
    for g_, w in zip(got, acc):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w).astype(np.int32))


def test_tails_schedule_shape():
    """The add alone: no doubling steps, the add's product rounds (2 for G1,
    3 over Fq2), the constants acc = infinity and, over Fq2, 3b' only; the
    packed header says so."""
    for deg in (1, 2):
        sched = S.tails_schedule(deg)
        assert sched["double"] == [] and sched["g"] == S.group_size(deg)
        assert sum(step[0][0] == S.MUL for step in sched["add"]) == 1 + deg
        assert sched["add"] and all(len({op == S.MUL for op, *_ in st}) == 1 for st in sched["add"])
        assert len(sched["consts"]) == 3 * deg + 2 * (deg - 1)
        assert sched["slots"] <= S.finish_schedule(deg)["slots"] < S.IDLE
        words = S.pack(sched)
        assert words[S.HDR_SDBL] == 0 and words[S.HDR_SADD] == len(sched["add"])
        assert len(words) == S.HDR_WORDS + 9 * len(sched["consts"]) + sched["g"] * len(sched["add"])


def test_tail_walk_edges():
    """m = 0 reads nothing; m = 2^nb reads the root alone; the clamp never
    binds where the bit is set."""
    assert S.tail_walk(0, 6) == []
    assert S.tail_walk(1 << 6, 6) == [(6, 0)]
    assert S.tail_walk(1, 6) == [(0, 0)]
    assert S.tail_walk(3, 2) == [(0, 1), (1, 0)]         # level 0: rev_2(3 - 1) = rev_2(0b10)
    assert S._brev64(1) == 1 << 63 and S._brev64(1 << 63) == 1


def test_msm_tails_wrapper_takes_no_cpu_tensor():
    """The wrapper launches or raises: CPU planes reach the plain version
    only through the dispatcher."""
    levels, m, nb = _pass(1, 1, 64, 3)
    with pytest.raises(ValueError, match="CUDA"):
        GM.msm_tails_planes(1, levels, m, nb)


def test_tail_cases_build_on_the_cpu():
    """kernels.cases.tails_cases at a small size: kernel side and plain side
    agree (both plain here); the work counts popcount(m) adds and reads."""
    cases = KC.tails_cases("cpu", np.random.default_rng(4), tails=((1, 1, 4, 64), (2, 1, 4, 64)))
    assert [c.kernel for c in cases] == ["msm_tails", "msm_tails"]
    for case, deg in zip(cases, (1, 2)):
        assert case.plain_once
        assert KC.max_abs_err(case.run(), case.plain()) == 0, case.label
        adds = int(re.search(r"adds=(\d+)", case.label).group(1))
        lanes = 64 * 9                                    # k W (B + 1) tail lanes
        assert case.products == KC.ADD_PRODUCTS[deg] * adds
        assert case.elements_moved == 3 * deg * (adds + lanes) and case.extra_bytes == 8 * lanes
        assert KC.bound_ms(case)[0] > 0


def test_tails_constants_match_the_cuda_sources():
    """The limits the Python side and csrc/ must agree on."""
    curve = (CSRC / "curve.cu").read_text()
    assert int(re.search(r"#define TAIL_MAX_LEVELS (\d+)", curve).group(1)) == GM.TAILS_MAX_LEVELS
    ntt = (CSRC / "ntt.cu").read_text()
    kib = int(re.search(r"#define NTT_PASS_SHARED_MAX \((\d+) \* 1024\)", ntt).group(1))
    assert kib * 1024 == gpu_ntt.PASS_ELEMENTS * 32
