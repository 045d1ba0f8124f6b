"""Kernels K1-K9 against their plain versions on the card (needs CUDA).

Run on a machine with an NVIDIA GPU (no jax needed there, hence
--noconftest):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Each test skips inside the `cuda` fixture when no card is present, so
every worker collects the same tests.  Comparisons are exact, tolerance 0:
integer arithmetic, and for the probe K7's f32fma a plain version that takes
each step exactly in float64 and rounds once, as the fused kernel does.
"""

import random

import pytest

import torch

from zklaim_tpu_torch import kernels as K
from zklaim_tpu_torch.entry import run_main_path, tiny_circuit
from zklaim_tpu_torch.groth16.api import prove, setup
from zklaim_tpu_torch.kernels.cases import kernel_cases, max_abs_err
from zklaim_tpu_torch.ntt import gpu_ntt

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    K.library()
    return torch.device("cuda:0")


@pytest.fixture(scope="module")
def cases(cuda):
    return kernel_cases(cuda, seed=1)


@pytest.mark.parametrize("kernel", list(K.KERNELS))
def test_kernel_matches_plain_at_main_path_shapes(cases, kernel):
    mine = [c for c in cases if c.kernel == kernel]
    assert mine
    for case in mine:
        before = K.LAUNCHES[kernel]
        got = case.run()
        torch.cuda.synchronize()
        assert K.LAUNCHES[kernel] > before, case.label
        want = case.plain()
        assert max_abs_err(got, want) == 0, case.label


def test_wrappers_reject_bad_operands(cuda):
    from zklaim_tpu_torch.ec.gpu_curve import point_add_planes, point_double_planes
    from zklaim_tpu_torch.ff.montgomery import FR, mont_mul

    a = torch.zeros((4, 16), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        mont_mul(FR, a.long(), a)
    with pytest.raises(ValueError):
        mont_mul(FR, a, a.cpu())
    p = torch.zeros((3, 16, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        point_add_planes(2, p, p)
    with pytest.raises(ValueError):
        point_double_planes(2, p)
    with pytest.raises(ValueError):
        point_double_planes(1, p.transpose(1, 2))


def test_point_double_on_strided_views(cuda):
    """K5 takes plane and row strides: a slice of a wider plane set doubles
    like its contiguous copy, and 2P equals P + P as points."""
    import numpy as np

    from zklaim_tpu_torch.ec import curve as C
    from zklaim_tpu_torch.ec.gpu_curve import point_add_planes, point_double_plain, point_double_planes
    from zklaim_tpu_torch.kernels.cases import random_points

    for deg in (1, 2):
        wide = random_points(deg, 96, np.random.default_rng(5), cuda)
        view = wide[..., 17:81]
        assert not view.is_contiguous()
        got = point_double_planes(deg, view)
        assert max_abs_err(got, point_double_plain(deg, view.contiguous())) == 0
        assert (C.planes_to_host_points(deg, got)
                == C.planes_to_host_points(deg, point_add_planes(deg, view, view)))


def test_credential_flow_statuses_on_card(cuda):
    """The zero-payload credential flow through claims.api.Context on the
    card: every status code as expected, K5 launched by proof_generate."""
    from zklaim_tpu_torch.entry import run_credential_path

    K.reset_launches()
    res = run_credential_path(cuda, num_payloads=0, requests=1, seed=11)
    assert res["statuses_ok"], (res["status"], res["expected"])
    assert res["reprove_launches"]["point_double"] == 2 * 263


def test_small_circuit_same_on_card_and_cpu(cuda):
    cs, witness = tiny_circuit()
    out = {}
    for dev in (cuda, "cpu"):
        pk, vk, qap = setup(cs, random.Random(3), dev)
        out[str(dev)] = (pk, vk, prove(pk, qap, witness, random.Random(4)))
    (gpk, gvk, gproof), (cpk, cvk, cproof) = out[str(cuda)], out["cpu"]
    for name in ("a_g1", "b_g1", "b_g2", "h_g1", "l_g1"):
        assert torch.equal(getattr(gpk, name).cpu(), getattr(cpk, name)), name
    assert gvk.ic == cvk.ic
    assert gproof == cproof


def test_main_path_launches_every_kernel(cuda):
    """On the small circuit (m = 512) every NTT stage fits in one K2 tile,
    so K3 must not launch there; the other kernels of the proving paths, K5
    included, must, and no probe kernel may."""
    K.reset_launches()
    res = run_main_path(cuda, requests=1, seed=9, tiny=True)
    assert res["verified"] == [True]
    assert res["unsatisfied_rejected"] and res["wrong_input_rejected"]
    assert res["m"] <= gpu_ntt.TILE
    assert K.LAUNCHES["ntt_stage"] == 0, K.LAUNCHES
    assert all(K.LAUNCHES[k] > 0 for k in K.PATH_KERNELS if k != "ntt_stage"), K.LAUNCHES
    assert all(K.LAUNCHES[k] == 0 for k in K.PROBE_KERNELS), K.LAUNCHES


def test_probe_wrappers_reject_bad_operands(cuda):
    from zklaim_tpu_torch.tools.grid_micro import point_add_tiled
    from zklaim_tpu_torch.tools.mont_micro import mont_chain
    from zklaim_tpu_torch.tools.padd_micro import point_add_chain
    from zklaim_tpu_torch.tools.pallas_op_micro import op_chain

    x = torch.zeros((16, 8), dtype=torch.int32, device=cuda)
    p = torch.zeros((3, 16, 8), dtype=torch.int32, device=cuda)
    for bad in (lambda: mont_chain(x.long(), 1), lambda: mont_chain(x.t(), 1),
                lambda: mont_chain(x, -1), lambda: op_chain("u32mul", x.float(), 1),
                lambda: op_chain("f32fma", x, 1), lambda: op_chain("u64mul", x, 1),
                lambda: point_add_tiled(p, p[..., :4], 4), lambda: point_add_tiled(p, p, 0),
                lambda: point_add_chain(p.transpose(1, 2), 1), lambda: point_add_chain(p, -1)):
        with pytest.raises(ValueError):
            bad()


def test_probes_scale_linearly_in_chain_length(cuda):
    """The compiler did not fold a probe's loop: the time of 4 K steps is
    well above that of K steps (between 2 and 6 times it), for every op, and
    no op runs above one instruction a lane a clock on every SM (132 SMs x
    128 lanes x 2 GHz): merged steps would."""
    from zklaim_tpu_torch.tools import mont_micro, pallas_op_micro
    from zklaim_tpu_torch.utils.profiling import best_ms

    x = mont_micro.probe_input(mont_micro.WIDE_LANES, cuda)
    t1, t4 = (best_ms(lambda k=k: mont_micro.mont_chain(x, k), cuda) for k in (256, 1024))
    assert 2 < t4 / t1 < 6, (t1, t4)
    for op in pallas_op_micro.OPS:
        v = pallas_op_micro.probe_input(op, pallas_op_micro.WIDE_COLS, cuda)
        t1, t4 = (best_ms(lambda k=k: pallas_op_micro.op_chain(op, v, k), cuda)
                  for k in (2000, 8000))
        assert 2 < t4 / t1 < 6, (op, t1, t4)
        assert v.numel() * 6000 / ((t4 - t1) * 1e-3) < 132 * 128 * 2e9, (op, t1, t4)


def test_bench_entry_point_in_a_fresh_process(cuda):
    """`python -m zklaim_tpu_torch.bench --full` and the default run each
    print one JSON row taken on the card (a fresh process: no CUDA context
    exists when the first row resets the peak-memory counter)."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    for args, metric in ((["--full"], "groth16_prover_latency_1payload"),
                         (["--log2n", "12"], "g1_msm_2^12_points_per_sec")):
        out = subprocess.run([sys.executable, "-m", "zklaim_tpu_torch.bench", *args], cwd=root,
                             capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-2000:]
        row = json.loads(out.stdout.strip().splitlines()[-1])
        assert row["metric"] == metric and row["impl"] == "torch" and row["value"] > 0
        assert row["device"].startswith(torch.cuda.get_device_name(0))
