"""Kernels K1-K5 against their plain versions on the card (needs CUDA).

Run on a machine with an NVIDIA GPU (no jax needed there, hence
--noconftest):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Each test skips inside the `cuda` fixture when no card is present, so
every worker collects the same tests.  Comparisons are exact (integer
arithmetic: tolerance 0).
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
        assert max_abs_err(got, case.plain()) == 0, case.label


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
    so K3 must not launch there; the others, K5 included, must."""
    K.reset_launches()
    res = run_main_path(cuda, requests=1, seed=9, tiny=True)
    assert res["verified"] == [True]
    assert res["unsatisfied_rejected"] and res["wrong_input_rejected"]
    assert res["m"] <= gpu_ntt.TILE
    assert K.LAUNCHES["ntt_stage"] == 0, K.LAUNCHES
    assert all(v > 0 for k, v in K.LAUNCHES.items() if k != "ntt_stage"), K.LAUNCHES
