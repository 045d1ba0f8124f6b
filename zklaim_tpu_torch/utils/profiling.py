"""Per-phase timing, optional device traces, and the timing helpers of the
measuring path.

Counterpart of zklaim_tpu/utils/profiling.py: explicit phase timers with
the benchmark CSV's phase names (issuer / prover / verifier) plus hooks
into torch.profiler for device traces.

Enable with ZKLAIM_PROFILE=1 (timing lines on stderr) and
ZKLAIM_TRACE_DIR=/path (one Chrome trace per traced region, viewable in
chrome://tracing or Perfetto).

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
import sys
import time
from dataclasses import dataclass, field
from functools import lru_cache

import torch


def _enabled() -> bool:
    return os.environ.get("ZKLAIM_PROFILE", "") not in ("", "0")


@dataclass
class PhaseTimer:
    """Accumulates wall-clock per named phase; thread-unsafe by design
    (one per pipeline, like the reference's per-worker clocks).

    The clock is the host's: a phase that ends with work still queued on
    the card must synchronise before it closes."""

    times_ms: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = (time.perf_counter() - t0) * 1e3
            self.times_ms[name] = self.times_ms.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            if _enabled():
                print(f"[zklaim-profile] {name}: {dt:.1f} ms", file=sys.stderr)

    def csv_row(self, num_payloads: int, sizes: tuple) -> str:
        """Reference benchmark CSV row (main_benchmark.c:163 schema)."""
        pk_b, vk_b, proof_b = sizes
        return (
            f"{int(time.time())},{num_payloads},"
            f"{self.times_ms.get('issuer', 0):.1f},"
            f"{self.times_ms.get('prover', 0):.1f},"
            f"{self.times_ms.get('verifier', 0):.1f},"
            f"{pk_b},{vk_b},{proof_b}"
        )


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


@contextlib.contextmanager
def annotate(name: str):
    """Named region visible in device traces (record_function)."""
    with torch.profiler.record_function(name):
        yield


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
