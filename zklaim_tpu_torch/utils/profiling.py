"""The program's spans and counters, optional device traces, and the
timing helpers of the measuring path.

Spans and counters: the layers of the normal path open `span("<layer>.<stage>")`
around their stages (claims.*, groth16.*, ntt.*, msm.*, verifier.*) and
count what their shapes say (`count("msm.lanes", n)`) or how many spans of
a name are open at once (`count_open`).  Each costs one flag test while
nothing records.  `recording()` switches recording on for a with block and
hands the block a `Recorder`, which keeps every span as (start_ns, end_ns,
name, parent) and every count as (time_ns, name, n), all on
`time.time_ns()`, the clock torch.profiler stamps its events with, so that
a span can be laid over a device trace directly.  Spans never synchronise
the card and never call torch.profiler.record_function (whose range can
come back as an event on the card); a tool that wants a stage's own time
passes `recording(sync=device)`, and each span then ends with a
synchronise.  The recorder takes every thread's spans: several holders
may prove at once, each on its own thread.  Each thread has its own stack
of open spans, so a span's parent is the span open on its own thread, and
`Recorder.threads` says which thread opened each span.

ZKLAIM_TRACE_DIR=/path writes one Chrome trace per `device_trace` region
(viewable in chrome://tracing or Perfetto).

`best_ms`, `device_ms` and `card_label` serve bench.py, the tools and
chip_smoke.py: a call's time on the card is taken with CUDA events (it holds
the host's time between launches), the card's own time for the call with
the replay of a captured CUDA graph, and every printed number carries the card's name and power
limit as nvidia-smi gives them.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import threading
import time
from collections import Counter
from functools import lru_cache

import torch


class Recorder:
    """What one `recording()` block records, from every thread.

    spans: (start_ns, end_ns, name, parent) in the order the spans opened;
    end_ns is None while a span is open, parent the index of the span open
    on the same thread when it opened (-1 where none was).  threads: the
    thread (threading.get_ident()) that opened each span, parallel to
    spans.  counts: (time_ns, name, n)."""

    def __init__(self, sync=None):
        self.sync = sync
        self.spans: list = []
        self.threads: list = []
        self.counts: list = []
        self._lock = threading.Lock()               # spans, threads and _opened change together
        self._local = threading.local()
        self._opened: Counter = Counter()           # name -> its spans open, on every thread

    @property
    def _open(self) -> list:
        """Indices of the spans open on the calling thread, innermost last."""
        stack = getattr(self._local, "open", None)
        if stack is None:
            stack = self._local.open = []
        return stack

    def self_ns(self) -> list:
        """Each span's self time, ns: its time less its children's (None
        while it is open)."""
        child_ns = [0] * len(self.spans)
        for start, end, _, parent in self.spans:
            if end is not None and parent >= 0:
                child_ns[parent] += end - start
        return [None if end is None else end - start - children
                for (start, end, _, _), children in zip(self.spans, child_ns)]


class _Span:
    __slots__ = ("rec", "name", "index")

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec, stack = self.rec, self.rec._open
        with rec._lock:
            self.index = len(rec.spans)
            rec.spans.append((time.time_ns(), None, self.name, stack[-1] if stack else -1))
            rec.threads.append(threading.get_ident())
            rec._opened[self.name] += 1
        stack.append(self.index)

    def __exit__(self, *exc):
        rec = self.rec
        if rec.sync is not None:
            sync(rec.sync)
        end = time.time_ns()
        with rec._lock:
            start, _, name, parent = rec.spans[self.index]
            rec.spans[self.index] = (start, end, name, parent)
            rec._opened[name] -= 1
        rec._open.pop()
        return False


_active: Recorder | None = None                     # the recorder of the open recording() block
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager around a stage of the program: recorded while a
    `recording()` block is open, a shared no-op otherwise."""
    if _active is None:
        return _OFF
    return _Span(_active, name)


def count(name: str, n: int) -> None:
    """Add n to counter `name`, while a `recording()` block is open."""
    if _active is not None:
        _active.counts.append((time.time_ns(), name, n))


def count_open(name: str, span_name: str) -> None:
    """Add to counter `name` how many spans `span_name` are open now, on
    every thread, while a `recording()` block is open."""
    rec = _active
    if rec is not None:
        rec.counts.append((time.time_ns(), name, rec._opened[span_name]))


@contextlib.contextmanager
def recording(sync=None):
    """Record the program's spans and counters for the with block, which
    receives the Recorder.  sync: a device to synchronise at each span's
    end (the tools' stage times), None for none (the benchmark's)."""
    global _active
    outer, _active = _active, Recorder(sync)
    try:
        yield _active
    finally:
        _active = outer


@contextlib.contextmanager
def device_trace(label: str = "zklaim"):
    """torch.profiler trace around a region when ZKLAIM_TRACE_DIR is set:
    writes <dir>/<label>.json (Chrome trace; CPU activity, and the card's
    where there is one)."""
    trace_dir = os.environ.get("ZKLAIM_TRACE_DIR", "")
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, f"{label}.json"))


# ---------------------------------------------------------------------------
# Timing helpers of bench.py and the tools
# ---------------------------------------------------------------------------


def sync(device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def best_ms(fn, device, runs: int = 3) -> float:
    """Least milliseconds of `runs` calls of fn() after one warm-up call: on
    a CUDA device between two CUDA events, on the CPU by the host clock."""
    fn()
    best = float("inf")
    if torch.device(device).type != "cuda":
        for _ in range(runs):
            t0 = time.perf_counter()
            fn()
            best = min(best, (time.perf_counter() - t0) * 1e3)
        return best
    torch.cuda.synchronize(device)
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(device)
        best = min(best, start.elapsed_time(end))
    return best


def device_ms(fn, calls: int = 10, reps: int = 5) -> float:
    """Milliseconds the card itself needs for one call of fn(): `calls` calls
    are captured into ONE CUDA graph, whose replay puts their kernels on the
    card back to back with no host code between them, and the replay is
    timed with CUDA events (mean of `reps` replays after a warm one).  What
    is left of the host is a graph's own gap of about a microsecond a kernel.
    `best_ms`, or a pair of events around plain calls, adds the host's time
    between launches.  fn must not synchronise or read a result back."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * calls)


@lru_cache(maxsize=None)
def _smi_lines() -> tuple:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return tuple(line.strip() for line in out.strip().splitlines())


def card_label(device) -> str:
    """"<name>, <power limit>" of a CUDA device as nvidia-smi prints them;
    "cpu" for the CPU (a CPU time is no device metric, and says so)."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    return _smi_lines()[device.index or 0]
