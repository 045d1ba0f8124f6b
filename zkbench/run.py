"""The benchmark of zklaim_tpu_torch: one run of one cell.

    python3 zkbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with a CUDA card.  The cell is
an entry of `workloads` in BENCHMARK.json.  With --trace 0 the result line
holds the cell's end-to-end metrics, with --trace 1 its per-layer metrics
(the window under torch.profiler).  The last line of standard output is
the result, a JSON object; the numbers that decided `correct` come last in
it, under `checks`, and as the last lines of standard error.

The run exits with a code other than 0, and prints no result, where no card
is present (or fewer than the cell needs), where the program cannot be
imported, or where a module of JAX or of the JAX package (zklaim_tpu) is
loaded once the window has closed.

--fault <name> breaks the timed path on purpose (the control runs; see
harness.inject); BENCHMARK.json's runs never pass it.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path.cwd()
FORBIDDEN = ("jax", "jaxlib", "flax", "zklaim_tpu")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is, as a
    whole, one of FORBIDDEN: `zklaim_tpu_torch` is not `zklaim_tpu`."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def log(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def main(argv=None, device=None) -> int:
    """Run a cell; `device` None means the card (the tests pass "cpu")."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--fault", choices=("stale_proof", "altered_proof"))
    p.add_argument("--bench", default=str(ROOT / "BENCHMARK.json"))
    args = p.parse_args(argv)

    bench = json.loads(Path(args.bench).read_text())
    sys.path.insert(0, str(Path(args.bench).resolve().parent))
    import torch

    from zkbench import harness

    spec = harness.load_cell(bench, args.workload, Path(args.bench).resolve().parent)
    if device is None:
        chips = spec["cell"]["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            log(f"no CUDA card, or fewer than the {chips} this cell needs: no result")
            return 2
        device = torch.device("cuda", 0)
    result = harness.run(spec, args.seed, args.seconds, bool(args.trace), device, T_PROCESS,
                         fault=args.fault, log=log)

    bad = forbidden_modules()
    if bad:
        log(f"modules of JAX or of the JAX package are loaded: {', '.join(bad)}: no result")
        return 3
    print(json.dumps(result), flush=True)
    for name, check in result["checks"].items():
        kind = "max" if "max" in check else "min"
        log(f"check {name} = {check['value']} ({kind} {check[kind]})")
    log(f"correct = {str(result['correct']).lower()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
