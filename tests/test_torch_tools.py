"""The profiles and probes of zklaim_tpu_torch.tools, driven on the CPU at
tiny sizes: each returns its rows, names the CPU as its device (a CPU time
is no device metric), and formats them.  The prover profile needs five
full MSMs a repetition and runs on the card only (chip_smoke.py).  Where a
tool checks a result (msm_probe --check) the check is exact.
"""

import pytest

import torch

from zklaim_tpu_torch.msm import pippenger as P
from zklaim_tpu_torch.tools import (
    layout_probe, msm_micro, msm_probe, msm_stages, pallas_micro, prove_profile, setup_profile,
    vpu_micro,
)

torch.set_num_threads(1)


def _on_cpu(rows):
    assert rows and all(r["device"] == "cpu" for r in rows)
    return rows


def test_msm_stages_rows_cover_the_pipeline():
    rows = _on_cpu(msm_stages.measure("cpu", log2n=1, runs=1))
    assert [r["stage"] for r in rows] == list(msm_stages.STAGES)
    assert all(r["ms"] >= 0 for r in rows)
    assert rows[-1]["cum_ms"] == pytest.approx(sum(r["ms"] for r in rows))
    lines = msm_stages.format_rows(rows)
    assert len(lines) == len(rows) + 2 and "flat lanes=64" in lines[0]


def test_msm_stages_refuses_more_than_one_pass():
    too_many = (P.MAX_LANES[1] // 32).bit_length()        # 2^k points: twice MAX_LANES lanes
    with pytest.raises(ValueError, match="one pass"):
        msm_stages.measure("cpu", log2n=too_many)


def test_window_partials_marks_do_not_change_the_result():
    from zklaim_tpu_torch import bench
    from zklaim_tpu_torch.ff.limbs import to_tensor

    rows = bench.make_points(1, 2, "cpu")
    scalars = to_tensor([[5] + [0] * 15, [0x8001] + [7] * 15], "cpu")
    seen = []
    marked = P._window_partials(1, [(rows, scalars)], 8, seen.append)
    plain = P._window_partials(1, [(rows, scalars)], 8)
    assert seen == list(msm_stages.STAGES[:-1])
    assert all(torch.equal(a, b) for a, b in zip(marked, plain))


def test_setup_profile_on_the_zero_payload_circuit():
    rows = _on_cpu(setup_profile.measure("cpu", num_payloads=0))
    phases = [r["phase"] for r in rows]
    for want in ("QAP/COO prep", "instance map (eval_at_tau)", "scalar prep (host)",
                 "ic host decode", "groth16.setup (tables warm)"):
        assert want in phases
    assert phases.count("TOTAL") == 2 and {r["group"] for r in rows} == {"steps", "issuer"}
    assert len(prove_profile.format_rows(rows)) == len(rows)


def test_msm_probe_checks_against_the_closed_form(monkeypatch):
    monkeypatch.setenv("ZKLAIM_MSM_LADDER_MAX", "2")
    rows = _on_cpu(msm_probe.measure("cpu", log2ns=(2,), cs=(8,), runs=1, check=True))
    assert [(r["log2n"], r["c"]) for r in rows] == [(2, 8)]             # 4 points: the flat pipeline
    assert all(r["correct"] is True for r in rows)
    assert "correct = True" in msm_probe.format_row(rows[0])


@pytest.mark.parametrize("tool,kwargs,count", [
    (msm_micro, {"w": 2, "n": 8, "rounds": 2, "doublings": 2}, 8),
    (layout_probe, {"log2n": 3, "runs": 1}, 9),
    (pallas_micro, {"log2ns": (2,)}, 3),
    (vpu_micro, {"n": 256, "reps": 4}, 5),
], ids=["msm_micro", "layout_probe", "pallas_micro", "vpu_micro"])
def test_tool_rows_on_the_cpu(tool, kwargs, count):
    rows = _on_cpu(tool.measure("cpu", **kwargs))
    assert len(rows) == count and all(r["ms"] >= 0 for r in rows)
    assert all(tool.format_row(r).startswith("[cpu]") for r in rows)
