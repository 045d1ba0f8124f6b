"""A traced run of a cell with the program's own spans and counters: each
idle gap of the card charged to the layer the host was in.

    python3 zkbench/trace_layers.py --workload <name> --seed <n> --seconds <s>

Run from the root of a checkout, as run.py.  The run is run.py's
`--trace 1` run (harness.run) with three differences:

- the program's recorder (zklaim_tpu_torch.utils.profiling.recording) is
  on from before the roles are set up;
- the trace is read by program_spans.record in place of tracing.record, so
  the breakdown's idle_gaps name the innermost span open over each gap;
- the result line adds the per-layer metrics of layer_metrics.json that
  list the cell (their readers are metrics/<name>.py).

Standard error adds the window's idle time beside its parts by layer (the
five layers', the steps' own, the harness's, any other span's), the
set-up spans' totals (program_spans.SETUP, before the window), the
program's spans per request and the traced rate.
"""

from __future__ import annotations

import json
import sys
import types
from pathlib import Path

sys.path.insert(0, str(Path.cwd()))

from zkbench import harness, program_spans, run  # noqa: E402

METRICS = json.loads((Path(__file__).resolve().parent / "layer_metrics.json").read_text())


def main(argv=None, device=None) -> int:
    """run.main's arguments but --trace; `device` None means the card (the
    tests pass "cpu")."""
    from zklaim_tpu_torch.utils.profiling import recording

    tracing, load_cell = harness.tracing, harness.load_cell

    def read(events, window, steps, requests):
        rec = program_spans.record(events, window, steps, requests, program.spans,
                                   program.counts)
        split = program_spans.idle_split(rec, {name for _, _, name in steps})
        run.log("idle s: " + f"{split['idle_s']:.6f} = " + " + ".join(
            f"{k} {v:.6f}" for k, v in split["parts_s"].items())
            + f" (unaccounted {split['unaccounted_s']:.9f}); device_idle_pct "
            + f"{100 * split['idle_s'] / rec['window_s']:.4f}")
        run.log("set-up split s: " + ", ".join(
            f"{k} {v:.3f}" for k, v in program_spans.setup_split(program.spans,
                                                                  window[0]).items()))
        run.log(f"program spans a request: {rec['program_spans'] / max(requests, 1):.1f}"
                f"; counts in the window: {json.dumps(rec['counts'])}")
        run.log(f"traced rate: {requests / rec['window_s']:.4f} requests/s over "
                f"{rec['window_s']:.3f} s")
        return rec

    def with_layer_metrics(bench, name, root):
        spec = load_cell(bench, name, root)
        spec["per_layer"] = spec["per_layer"] + [m for m in METRICS if name in m["workloads"]]
        return spec

    harness.tracing = types.SimpleNamespace(record=read, breakdown=tracing.breakdown)
    harness.load_cell = with_layer_metrics
    try:
        with recording() as program:
            return run.main(list(sys.argv[1:] if argv is None else argv) + ["--trace", "1"],
                            device=device)
    finally:
        harness.tracing, harness.load_cell = tracing, load_cell


if __name__ == "__main__":
    sys.exit(main())
