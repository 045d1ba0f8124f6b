"""The program's own spans and counters in a traced run, laid over the
card's idle time.

zklaim_tpu_torch.utils.profiling records, while a `recording()` block is
open, every span the program opens at its layer boundaries as (start_ns,
end_ns, name, parent) and every count as (time_ns, name, n), on
`time.time_ns()`, the clock of the harness's step spans and of the
profiler's events.  Spans nest: a step span (steps/*.py) holds
claims.proof_generate, which holds groth16.prove, which holds msm.g1, ...
`flatten` cuts such a tree into disjoint segments, each labelled by the
innermost span open over it, and `record` runs tracing.record's walk over
the segments, so that each idle gap of the card is charged to the stage
the host was in.  Given the step spans alone, `record` is tracing.record.

A span's name is <layer>.<stage>; LAYERS maps each prefix to its layer's
name in PERF.md's list of layers.
"""

from __future__ import annotations

from . import tracing

LAYERS = {"claims": "credential API", "groth16": "groth16", "ntt": "ntt", "msm": "msm",
          "verifier": "host verifier"}
SETUP = ("claims.trusted_setup", "claims.circuit", "claims.pk_import", "groth16.setup",
         "serde.pk_to_bytes")


def flatten(spans) -> list:
    """Nested spans, each (start, end, name, ...), -> disjoint segments
    (start, end, name) in time order, each labelled by the innermost span
    open over it; time that no span covers is left out.  A span still
    open (end None) is skipped; a child that outlasts its parent is cut
    at the parent's end."""
    closed = sorted(((s[0], s[1], s[2]) for s in spans if s[1] is not None),
                    key=lambda s: (s[0], -s[1]))
    out, stack, at = [], [], None                   # stack: (end, name), innermost last

    def close_until(t):
        nonlocal at
        while stack and stack[-1][0] <= t:
            end, name = stack.pop()
            if end >= at:
                out.append((at, end, name))
                at = end

    for start, end, name in closed:
        close_until(start)
        if stack:
            if start > at:
                out.append((at, start, stack[-1][1]))
            end = min(end, stack[-1][0])
        at = start
        stack.append((end, name))
    close_until(float("inf"))
    return out


def record(events, window: tuple, steps: list, requests: int, program=None,
           counts=None) -> dict:
    """tracing.record's record, with the idle time charged to the innermost
    span of the step spans `steps` ((start, end, name), ns) and the
    program's spans `program` ((start, end, name, parent), ns).  Where
    `program` is given, idle_s_by_span also names (with 0) every program
    span in the window that no idle gap met, and the record adds "counts",
    the program's counts ((time, name, n), ns) in the window by name, and
    "program_spans", the number of program spans in the window."""
    if program is None:
        return tracing.record(events, window, steps, requests)
    lo, hi = window
    inside = [s for s in program if s[1] is not None and s[0] < hi and s[1] > lo]
    rec = tracing.record(events, window, flatten(list(steps) + inside), requests)
    for _, _, name, _ in inside:
        rec["idle_s_by_span"].setdefault(name, 0.0)
    totals = {}
    for t, name, n in counts or ():
        if lo <= t < hi:
            totals[name] = totals.get(name, 0) + n
    rec["counts"] = totals
    rec["program_spans"] = len(inside)
    return rec


def layer_idle_ms(rec: dict, prefix: str):
    """The card's idle time charged to spans `<prefix>.*`, ms per completed
    request; None where the trace saw no device activity or no such span."""
    mine = [s for name, s in rec.get("idle_s_by_span", {}).items()
            if name.startswith(prefix + ".")]
    if not mine or not rec["kernel_count"] or not rec["requests"]:
        return None
    return 1e3 * sum(mine) / rec["requests"]


def idle_split(rec: dict, steps) -> dict:
    """The window's idle time (s) beside its parts: each layer's, the step
    spans' own (`steps`: their names), the harness's, and any other span's;
    "unaccounted_s" is the idle time less the parts (0 up to rounding)."""
    by_span = rec["idle_s_by_span"]
    parts = {prefix: sum(s for name, s in by_span.items() if name.startswith(prefix + "."))
             for prefix in LAYERS}
    parts["steps"] = sum(by_span.get(name, 0.0) for name in set(steps))
    parts["harness"] = by_span.get("harness", 0.0)
    parts["other"] = sum(by_span.values()) - sum(parts.values())
    idle = rec["window_s"] - rec["busy_s"]
    return {"idle_s": idle, "parts_s": parts,
            "unaccounted_s": idle - sum(parts.values())}


def setup_split(program, before_ns: int) -> dict:
    """Seconds of the set-up spans (SETUP) that ended before `before_ns`."""
    out = dict.fromkeys(SETUP, 0.0)
    for start, end, name, _ in program:
        if name in out and end is not None and end <= before_ns:
            out[name] += (end - start) / 1e9
    return out
