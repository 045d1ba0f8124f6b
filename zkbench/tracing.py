"""The traced run's record: what torch.profiler saw on the card during the
window, read from its events in memory (no trace file is written).

The profiler records the card's activity alone (CUDA activity, no CPU
operators: recording each of the program's host operators would slow a
proof by about a second at N = 20 and inflate the idle time it measures).
The window and the spans that the steps (steps/*.py) open around their
calls into the credential API are taken on the host's clock,
`time.time_ns()`, the time base the profiler gives its events in.  From
the events this module takes the device's activity (kernels, copies, sets)
within the window, its busy time as the union of their intervals, the
kernels by name, and the idle time between them by the span that held the
host meanwhile ("harness" where none did).
"""

from __future__ import annotations

from collections import Counter

COPIES = ("Memcpy", "Memset")                      # the profiler's names for copies and sets


def record(events, window: tuple, spans: list, requests: int) -> dict:
    """The record the per-layer readers read, from the profiler's raw events
    (`prof.profiler.kineto_results.events()`), the window and the host's
    spans ((start, end, name), ns) and the requests completed in the window."""
    from torch.autograd import DeviceType

    card = DeviceType.CUDA
    device = []
    for e in events:
        if e.device_type() == card:
            start = e.start_ns()
            device.append((start, start + e.duration_ns(), e.name()))
    device.sort()
    kernels = {}                                    # name -> [count, ns]
    lo, hi = window
    busy, count = [], 0
    for start, end, name in device:
        if end <= lo or start >= hi:
            continue
        if not name.startswith(COPIES):
            count += 1
            k = kernels.setdefault(name, [0, 0])
            k[0] += 1
            k[1] += end - start
        start, end = max(start, lo), min(end, hi)
        if busy and start <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], end)
        else:
            busy.append([start, end])
    gaps, at = [], lo
    for start, end in busy:
        if start > at:
            gaps.append((at, start))
        at = end
    if hi > at:
        gaps.append((at, hi))
    spans = sorted(spans)
    idle, i = Counter(), 0
    for start, end in gaps:                         # gaps and spans in order: one walk
        while i < len(spans) and spans[i][1] <= start:
            i += 1
        at, j = start, i
        while j < len(spans) and spans[j][0] < end:
            lo_s, hi_s = max(spans[j][0], start), min(spans[j][1], end)
            idle["harness"] += max(0, lo_s - at)
            idle[spans[j][2]] += hi_s - lo_s
            at = hi_s
            j += 1
        idle["harness"] += max(0, end - at)
    return {
        "window_s": (hi - lo) / 1e9,
        "busy_s": sum(end - start for start, end in busy) / 1e9,
        "kernel_count": count,
        "requests": requests,
        "kernels": {name: (n, ns / 1e9) for name, (n, ns) in kernels.items()},
        "idle_s_by_span": {name: ns / 1e9 for name, ns in idle.items()},
        "events": len(device),
        # how far the card's first and last activity lie inside the window (s):
        # both small and positive where the two clocks agree
        "edges_s": ((device[0][0] - lo) / 1e9, (hi - device[-1][1]) / 1e9) if device else None,
    }


def breakdown(rec: dict, top: int = 10) -> dict:
    """The result line's `breakdown`: the kernels that took the most device
    time, and the idle time by what the host was doing, seconds each."""
    ops = sorted(rec["kernels"].items(), key=lambda kv: -kv[1][1])[:top]
    gaps = sorted(rec["idle_s_by_span"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[name[:160], s] for name, (_, s) in ops],
            "idle_gaps": [[name, s] for name, s in gaps]}
