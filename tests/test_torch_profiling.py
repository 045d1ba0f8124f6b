"""utils.profiling of the port: the span and counter recorder, device_trace,
and the timing helpers the measuring path uses.

The recorder's times are checked exactly on a made-up clock (time.time_ns
replaced by a counter), so parents, self times and windows are integers.
"""

import itertools
import json

import pytest

import torch

from zklaim_tpu_torch.utils import profiling as TP

torch.set_num_threads(1)


@pytest.fixture
def clock(monkeypatch):
    """time.time_ns as 0, 10, 20, ...: every reading 10 ns after the last."""
    ticks = itertools.count(0, 10)
    monkeypatch.setattr(TP.time, "time_ns", lambda: next(ticks))


def test_off_records_nothing():
    """Outside a recording block a span is one shared no-op and a count is
    dropped; a recorder sees only what its own block did."""
    assert TP.span("a") is TP.span("b")
    with TP.span("outside"):
        TP.count("msm.lanes", 4)
    with TP.recording() as rec:
        with TP.span("inside"):
            TP.count("msm.lanes", 2)
    with TP.span("after"):
        TP.count("msm.lanes", 8)
    assert [s[2] for s in rec.spans] == ["inside"]
    assert [(name, n) for _, name, n in rec.counts] == [("msm.lanes", 2)]


def test_nested_spans_record_parents_and_self_time(clock):
    with TP.recording() as rec:
        with TP.span("groth16.prove"):          # opens at 0
            with TP.span("ntt.h"):               # 10
                with TP.span("ntt.transforms"):  # 20, closes at 30
                    pass
            with TP.span("msm.g1"):              # 50, closes at 60; the parent at 70
                pass
    assert rec.spans == [(0, 70, "groth16.prove", -1), (10, 40, "ntt.h", 0),
                         (20, 30, "ntt.transforms", 1), (50, 60, "msm.g1", 0)]
    assert rec.self_ns() == [70 - 30 - 10, 30 - 10, 10, 10]


def test_spans_of_one_name_keep_their_own_parents(clock):
    with TP.recording() as rec:
        for _ in range(3):
            with TP.span("msm.pass"):
                with TP.span("msm.digits"):
                    pass
    assert [s[3] for s in rec.spans] == [-1, 0, -1, 2, -1, 4]
    assert rec.self_ns() == [20, 10] * 3


def test_an_exception_closes_every_open_span(clock):
    with TP.recording() as rec:
        with pytest.raises(ValueError, match="unsatisfied"):
            with TP.span("claims.proof_generate"):
                with TP.span("groth16.prove"):
                    with TP.span("groth16.check"):
                        raise ValueError("unsatisfied constraint")
        with TP.span("claims.proof_generate"):
            pass
    assert all(end is not None for _, end, _, _ in rec.spans)
    assert [(name, parent) for _, _, name, parent in rec.spans] == [
        ("claims.proof_generate", -1), ("groth16.prove", 0), ("groth16.check", 1),
        ("claims.proof_generate", -1)]
    assert rec._open == []


def test_an_open_span_has_no_end_yet(clock):
    with TP.recording() as rec:
        with TP.span("claims.proof_generate"):
            assert rec.spans == [(0, None, "claims.proof_generate", -1)]
            assert rec.self_ns() == [None]
    assert rec.spans == [(0, 10, "claims.proof_generate", -1)]


def test_counts_inside_and_outside_a_window(clock):
    """Each count carries its time, so a window keeps only its own."""
    with TP.recording() as rec:
        TP.count("msm.lanes", 8)                 # at 0: before the window
        TP.count("msm.lanes", 4)                 # 10
        TP.count("msm.padded_lanes", 1)          # 20
        TP.count("msm.lanes", 2)                 # 30: after it
    window = (5, 25)
    inside = {}
    for t, name, n in rec.counts:
        if window[0] <= t < window[1]:
            inside[name] = inside.get(name, 0) + n
    assert inside == {"msm.lanes": 4, "msm.padded_lanes": 1}
    assert sum(n for _, name, n in rec.counts if name == "msm.lanes") == 14


def test_sync_mode_synchronises_at_each_span_end(monkeypatch, clock):
    """recording(sync=device), the tools' mode: each span ends with a
    synchronise of that device, taken before the span's end time."""
    calls = []
    monkeypatch.setattr(TP, "sync", lambda device: calls.append((device, TP.time.time_ns())))
    with TP.recording(sync="cuda:0") as rec:
        with TP.span("msm.pass"):
            with TP.span("msm.digits"):
                pass
    assert calls == [("cuda:0", 20), ("cuda:0", 40)]
    assert rec.spans == [(0, 50, "msm.pass", -1), (10, 30, "msm.digits", 0)]
    with TP.recording() as plain:                # the benchmark's mode: no synchronise
        with TP.span("msm.pass"):
            pass
    assert len(calls) == 2 and len(plain.spans) == 1


def test_recording_blocks_nest_and_restore_the_outer_one():
    with TP.recording() as outer:
        with TP.span("a"):
            with TP.recording() as inner:
                with TP.span("b"):
                    pass
        with TP.span("c"):
            pass
    assert [s[2] for s in outer.spans] == ["a", "c"]
    assert [s[2] for s in inner.spans] == ["b"]
    assert TP._active is None


def test_spans_add_no_profiler_event():
    """A span is no record_function range: under torch.profiler it adds no
    event, so a trace counts the same events with recording on."""
    from torch.profiler import ProfilerActivity, profile

    def names(record):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            if record:
                with TP.recording(), TP.span("groth16.prove"), TP.span("msm.g1"):
                    torch.ones(64).sum()
            else:
                torch.ones(64).sum()
        return sorted(e.name for e in prof.events())

    assert names(True) == names(False)
    assert not any(n.startswith(("groth16.", "msm.")) for n in names(True))


def test_device_trace_without_a_directory_is_a_no_op(monkeypatch, tmp_path):
    monkeypatch.delenv("ZKLAIM_TRACE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with TP.device_trace("region"):
        torch.ones(4).sum()
    assert list(tmp_path.iterdir()) == []


def test_device_trace_writes_a_chrome_trace(monkeypatch, tmp_path):
    out = tmp_path / "traces"
    monkeypatch.setenv("ZKLAIM_TRACE_DIR", str(out))
    with TP.device_trace("region"):
        torch.ones(64).sum()
    trace = json.loads((out / "region.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::sum" in names


def test_best_ms_and_card_label_on_the_cpu():
    calls = []
    ms = TP.best_ms(lambda: calls.append(1), "cpu", runs=4)
    assert len(calls) == 5 and ms >= 0           # one warm-up call, then the runs
    assert TP.card_label("cpu") == "cpu"
    TP.sync("cpu")                               # nothing to wait for
