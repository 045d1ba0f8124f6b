"""The program's spans over the card's idle time (program_spans.py, the
readers of layer_metrics.json, trace_layers.py), on the CPU: the nested
walk on a hand-built span tree, the same record as tracing.record's where
only the step spans are given, the idle time's sum by layer, the readers'
None where their spans or counters are absent, and a traced run of the
zero-payload configuration with the program's recorder on.

Run from the root of the repository:
    python -m pytest zkbench/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from zkbench import harness, program_spans, tracing, trace_layers

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[2]
IDLE = ("claims_idle_ms", "groth16_idle_ms", "ntt_idle_ms", "msm_idle_ms", "verifier_idle_ms")


class _Event:
    """A profiler event on the card: a name and a time span."""

    def __init__(self, name, start, end):
        self.n, self.s, self.e = name, start, end

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA

    def name(self):
        return self.n

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.e - self.s


def reader(name):
    return harness.reader(ROOT, name)


# one proof in a window of 0 ... 1000 ns: the step span proof_generate
# (0-900) holds the program's claims.proof_generate (100-800), which holds
# the witness (100-200) and groth16.prove (200-800), which holds msm.g1
# (300-700) with one pass (300-600) of two stages; the card runs 250-300
# and 450-500 only
STEPS = [(0, 900, "proof_generate")]
PROGRAM = [(100, 800, "claims.proof_generate", -1), (100, 200, "claims.witness", 0),
           (200, 800, "groth16.prove", 0), (300, 700, "msm.g1", 2), (300, 600, "msm.pass", 3),
           (300, 400, "msm.digits", 4), (400, 600, "msm.sort", 4),
           (2000, 2100, "claims.circuit", -1)]               # after the window
EVENTS = [_Event("k1", 250, 300), _Event("Memcpy HtoD", 450, 500)]


def test_flatten_labels_each_stretch_by_its_innermost_span():
    assert program_spans.flatten(STEPS + PROGRAM[:-1]) == [
        (0, 100, "proof_generate"), (100, 200, "claims.witness"),
        (200, 300, "groth16.prove"), (300, 400, "msm.digits"), (400, 600, "msm.sort"),
        (600, 600, "msm.pass"), (600, 700, "msm.g1"), (700, 800, "groth16.prove"),
        (800, 800, "claims.proof_generate"), (800, 900, "proof_generate")]
    # (a parent that ends with its last child leaves an empty segment)
    # an open span is skipped; a child that outlasts its parent is cut there
    assert program_spans.flatten([(0, 10, "a"), (5, 20, "b"), (30, None, "c")]) == [
        (0, 5, "a"), (5, 10, "b"), (10, 10, "a")]


def test_nested_walk_charges_each_gap_to_the_innermost_span():
    counts = [(150, "msm.lanes", 8), (150, "msm.padded_lanes", 6), (1500, "msm.lanes", 8)]
    rec = program_spans.record(EVENTS, (0, 1000), STEPS, 1, PROGRAM, counts)
    assert rec["idle_s_by_span"] == pytest.approx({
        "proof_generate": 200e-9, "claims.witness": 100e-9, "groth16.prove": 150e-9,
        "msm.digits": 100e-9, "msm.sort": 150e-9, "msm.g1": 100e-9,
        "claims.proof_generate": 0, "msm.pass": 0, "harness": 100e-9})
    assert rec["counts"] == {"msm.lanes": 8, "msm.padded_lanes": 6}
    assert rec["program_spans"] == 7
    assert rec["busy_s"] == pytest.approx(100e-9) and rec["kernel_count"] == 1
    assert tracing.breakdown(rec)["idle_gaps"][0][0] == "proof_generate"


def test_with_the_step_spans_alone_the_record_is_tracings():
    """Today's inputs (tests/test_zkbench_harness.py's): the same record,
    key for key, with the spans flattened or not."""
    events = [_Event("k1", 100, 300), _Event("k1", 250, 400), _Event("Memcpy HtoD", 500, 550),
              _Event("k2", 1100, 1200)]
    for spans in ([(600, 1000, "verify"), (0, 600, "proof_generate")], [(0, 50, "claim")], []):
        want = tracing.record(events, (0, 1000), spans, 2)
        assert program_spans.record(events, (0, 1000), spans, 2) == want
        assert tracing.record(events, (0, 1000), program_spans.flatten(spans), 2) == want


def test_the_idle_time_adds_up_by_layer():
    rec = program_spans.record(EVENTS, (0, 1000), STEPS, 1, PROGRAM, [])
    split = program_spans.idle_split(rec, {"proof_generate"})
    assert split["idle_s"] == pytest.approx(900e-9)
    assert split["parts_s"] == pytest.approx({
        "claims": 100e-9, "groth16": 150e-9, "ntt": 0, "msm": 350e-9, "verifier": 0,
        "steps": 200e-9, "harness": 100e-9, "other": 0})
    assert abs(split["unaccounted_s"]) < 1e-12
    layers = sum(reader(name).read(rec) or 0 for name in IDLE)
    assert layers == pytest.approx(1e3 * 600e-9)        # ms a request, one request


def test_readers_leave_out_what_they_cannot_read():
    """None where the program recorded no span of the layer (the parent of
    this change, or a layer a cell does not run), where the card did
    nothing, and where no lane was counted."""
    flat = tracing.record(EVENTS, (0, 1000), STEPS, 1)
    assert all(reader(name).read(flat) is None for name in IDLE + ("msm_padding_pct",))
    rec = program_spans.record(EVENTS, (0, 1000), STEPS, 1, PROGRAM, [])
    assert reader("verifier_idle_ms").read(rec) is None
    assert reader("ntt_idle_ms").read(rec) is None
    assert reader("msm_idle_ms").read(rec) == pytest.approx(350e-6)
    assert reader("msm_idle_ms").read({**rec, "kernel_count": 0}) is None
    assert reader("msm_padding_pct").read(rec) is None
    assert reader("msm_padding_pct").read(
        {"counts": {"msm.lanes": 4_718_592, "msm.padded_lanes": 1_637_308}}) == (
        100 * 1_637_308 / 4_718_592)                       # 34.70 %, N = 20


def test_setup_split_takes_the_set_up_spans_before_the_window():
    program = PROGRAM + [(0, 50, "groth16.setup", -1), (3000, None, "claims.pk_import", -1)]
    split = program_spans.setup_split(program, 1000)
    assert split == pytest.approx({"claims.trusted_setup": 0, "claims.circuit": 0,
                                   "claims.pk_import": 0, "groth16.setup": 50e-9,
                                   "serde.pk_to_bytes": 0})
    assert program_spans.setup_split(program, 3000)["claims.circuit"] == pytest.approx(100e-9)


def test_layer_metrics_keep_to_the_contract():
    """The entries a benchmark change would append to per_layer: a reader
    each, a layer of PERF.md's list, an end-to-end metric each cell of it
    reports."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    taken = {m["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for m in bench[k]}
    for m in trace_layers.METRICS:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["name"] not in taken and callable(reader(m["name"]).read)
        assert m["layer"] in program_spans.LAYERS.values()
        assert m["source"] in ("program_span", "program_counter")
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", cells))
    assert [m["name"] for m in trace_layers.METRICS] == list(IDLE) + ["msm_padding_pct"]


def test_a_tiny_traced_run_with_the_programs_spans(tmp_path, capsys, monkeypatch):
    """The zero-payload configuration through trace_layers.main on the CPU:
    correct, the breakdown's idle gaps named by the program's spans (on the
    CPU the whole window is idle), the padding exact (N = 0: G1 4 sums of 2
    points, 6 of them infinity; G2 1 of 2, 1), the idle metrics left out
    (no device activity), and the idle time's parts logged."""
    import test_zkbench_harness as H

    monkeypatch.setattr(trace_layers, "METRICS", [
        {**m, "workloads": ["tiny"]} for m in trace_layers.METRICS
        if "n1.present" in m["workloads"]])               # the cell of the mix
    args = ["--workload", "tiny", "--seed", str(2**31 + 7), "--seconds", "0.5",
            "--bench", str(H._tiny_bench(tmp_path, "present"))]
    assert trace_layers.main(args, device="cpu") == 0
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["metrics"] == {"msm_padding_pct": {"value": 70.0, "unit": "%"}}
    gaps = {name for name, _ in line["breakdown"]["idle_gaps"]}
    assert gaps & {"claims.witness", "groth16.finish", "verifier.pairing", "msm.finish"}
    assert "set-up split s: claims.trusted_setup" in out.err and "program spans a request" in out.err
    assert harness.tracing is tracing                    # put back
