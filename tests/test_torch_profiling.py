"""utils.profiling of the port: the span and counter recorder, device_trace,
and the timing helpers the measuring path uses.

The recorder's times are checked exactly on a made-up clock (time.time_ns
replaced by a counter), so parents, self times and windows are integers.
"""

import itertools
import json
import threading

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


def test_two_threads_keep_their_own_parents_and_every_count():
    """Two holders' spans interleave (A opens, B opens, A closes, B closes,
    by handshake) inside a span of the main thread: each span's parent is
    the span open on its own thread, rec.threads names the thread of each
    span, and count_open sees the spans of a name open on both threads.
    Then no span or count is lost to a race: eight threads of 500 spans
    and counts each, under a shortened switch interval."""
    import sys

    go_a, a_opened, b_opened, a_closed = (threading.Event() for _ in range(4))
    ident = {}

    def holder(name, wait_open, opened, wait_close, closed):
        ident[name] = threading.get_ident()
        assert wait_open.wait(10)
        with TP.span("claims.proof_generate"):
            TP.count_open("claims.in_flight", "claims.proof_generate")
            with TP.span(f"claims.witness.{name}"):
                opened.set()
                assert wait_close.wait(10)
        closed.set()

    with TP.recording() as rec:
        with TP.span("window"):
            a = threading.Thread(target=holder, args=("a", go_a, a_opened, b_opened, a_closed))
            b = threading.Thread(target=holder,
                                 args=("b", a_opened, b_opened, a_closed, threading.Event()))
            a.start(), b.start()
            go_a.set()
            a.join(10), b.join(10)
    assert not a.is_alive() and not b.is_alive()
    assert [name for _, _, name, _ in rec.spans] == [
        "window", "claims.proof_generate", "claims.witness.a", "claims.proof_generate",
        "claims.witness.b"]
    assert [parent for _, _, _, parent in rec.spans] == [-1, -1, 1, -1, 3]
    assert rec.threads == [threading.get_ident(), ident["a"], ident["a"], ident["b"],
                           ident["b"]]
    assert [n for _, _, n in rec.counts] == [1, 2]
    assert all(end is not None for _, end, _, _ in rec.spans) and rec._open == []

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with TP.recording() as rec:
            def spans():
                for _ in range(500):
                    with TP.span("msm.pass"):
                        TP.count("msm.lanes", 1)
            threads = [threading.Thread(target=spans) for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(rec.spans) == len(rec.threads) == len(rec.counts) == 8 * 500
    assert all(parent == -1 and end is not None for _, end, _, parent in rec.spans)
    assert rec._opened["msm.pass"] == 0


def test_a_single_thread_records_its_own_thread(clock):
    """One thread: the tree as before, every span of that thread, and
    count_open counting the spans of a name open at that moment."""
    with TP.recording() as rec:
        with TP.span("groth16.prove"):                                  # 0
            TP.count_open("claims.in_flight", "groth16.prove")          # 10
            with TP.span("msm.g1"):                                     # 20, closes at 40
                TP.count_open("claims.in_flight", "claims.proof_generate")   # 30
    assert rec.spans == [(0, 50, "groth16.prove", -1), (20, 40, "msm.g1", 0)]
    assert rec.threads == [threading.get_ident()] * 2
    assert rec.counts == [(10, "claims.in_flight", 1), (30, "claims.in_flight", 0)]


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
