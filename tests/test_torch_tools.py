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


def test_h_split_is_h_plain_step_by_step():
    """The split of h_pipeline that prove_profile prints, on the small
    circuit: groth16.api.h_plain with a mark hook calls it once a step, in
    order, and gives the same H coefficients as without; an unsatisfied
    witness raises before the transforms."""
    from zklaim_tpu_torch.entry import tiny_circuit
    from zklaim_tpu_torch.ff.limbs import to_tensor
    from zklaim_tpu_torch.groth16 import api as A
    from zklaim_tpu_torch.groth16.qap import QAP

    cs, witness = tiny_circuit()
    qap = QAP.for_cs(cs, "cpu")
    w_plain = to_tensor(A.witness_plain_limbs(witness), "cpu")
    marks = []
    h = A.h_plain(qap, w_plain, witness, mark=marks.append)
    assert torch.equal(h, A.h_plain(qap, w_plain, witness))
    assert marks == [
        "witness map (to_mont + constraint_evals)", "satisfaction check",
        "3 intt + 3 coset_ntt (6 transforms, K1 scalings)", "pointwise (a b - c) / Z",
        "coset_intt (7th transform, K1 scalings)", "from_mont"]
    bad = w_plain.clone()
    bad[-1, 0] ^= 1
    marks.clear()
    with pytest.raises(ValueError, match="unsatisfied"):
        A.h_plain(qap, bad, witness, mark=marks.append)
    assert marks == ["witness map (to_mont + constraint_evals)"]


def test_ntt_profile_rows_on_the_cpu():
    from zklaim_tpu_torch.tools import ntt_profile

    rows = _on_cpu(ntt_profile.measure("cpu", log2ns=(3, 5), calls=2, clusters=(2,)))
    assert [(r["log2n"], r["step"]) for r in rows] == [
        (k, step) for k in (3, 5)
        for step in ntt_profile.STEPS + ("K2 ntt_local (planes, cluster of 2)",)]
    assert all(r["call_ms"] >= 0 and r["device_ms"] is None for r in rows)
    assert all("device not measured" in line for line in ntt_profile.format_rows(rows))


SASS = """
        Function : _Z17mont_chain_kernelPKilPilli
        /*0000*/                   LDC R1, c[0x0][0x28] ;                     /* 0x00000a00ff017b82 */
        /*0010*/                   IMAD.WIDE.U32 R2, R5, R6, RZ ;             /* 0x0000000000000000 */
        /*0020*/                   IADD3 R8, P0, R2, R9, RZ ;                 /* 0x0000000000000000 */
        /*0030*/                   IADD3.X R10, R3, R11, RZ, P0, !PT ;        /* 0x0000000000000000 */
        /*0040*/                   LOP3.LUT R12, R7, R7, RZ, 0xfc, !PT ;      /* 0x0000000000000000 */
        /*0050*/                   ISETP.NE.AND P1, PT, R10, RZ, PT ;         /* 0x0000000000000000 */
        /*0060*/               @P1 BRA 0x10 ;                                 /* 0x0000000000000000 */
        /*0070*/                   STG.E desc[UR4][R12.64], R10 ;             /* 0x0000000000000000 */
        /*0080*/                   EXIT ;                                     /* 0x0000000000000000 */
"""


def test_kernel_ab_reads_a_loop_of_sass():
    """tools/kernel_ab.py's SASS reading on a made-up loop: the body runs
    from the backward branch's target to the branch (6 instructions, one
    IMAD-class), and its critical path follows the wide product's register
    pair and the carry predicate into the compare and the branch (5)."""
    from zklaim_tpu_torch.tools import kernel_ab

    funcs = kernel_ab.parse_sass(SASS)
    assert list(funcs) == ["_Z17mont_chain_kernelPKilPilli"]
    body = kernel_ab.loop_body(funcs["_Z17mont_chain_kernelPKilPilli"])
    assert [i[0] for i in body] == [0x10, 0x20, 0x30, 0x40, 0x50, 0x60]
    assert kernel_ab.loop_stats(funcs, "mont_chain_kernel") == {
        "function": "_Z17mont_chain_kernelPKilPilli", "instructions": 6, "imad_class": 1,
        "critical_path": 5}
    assert kernel_ab._label("K8 point_add_tiled G1 n=9 tile=4 threads=4") == \
        "K8 point_add_tiled G1 n=9 tile=4"
