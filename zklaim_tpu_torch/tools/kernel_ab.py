"""Two versions of the kernels on one card, in turns: every kernel case's
device time from this tree and from another checkout, the probes' rows,
the stages of an MSM pass and a warm proof, and the SASS of the Montgomery
product's loop.

    git archive <commit> | tar -x -C build/parent
    python -m zklaim_tpu_torch.tools.kernel_ab --other build/parent [--out FILE]

Five fresh processes run one after the other, each building its tree's
kernels (cached by source hash under that tree's build/kernels):
plain (this tree: the plain versions' ms), other, this, this, other.  Each
kernel process times every case of kernels/cases.py:kernel_cases (seed
20261016, as chip_smoke.py) by graph replay (utils/profiling.device_ms),
runs the four probes' measure(), and times K6, K9 and K7's u32mul on one
warp alone (32 lanes, chain lengths differenced): the latency of one
product, of one add step and of one step of two dependent instructions
(LOP3, IMAD) with nothing beside them.  It also times, under labels that
start "both trees:", K6 on ragged lane counts (1,023, 1,101 and
mont_micro.WIDE_LANES + 77, K = 3) and K7's four ops at the tool's chain
length (pallas_op_micro.CHAIN[0]), which a tree's case list may lack.
Then the path as a user meets it, with the tree's own tools: the stages of
one G1 pass (tools.msm_stages, 2^16 points at c = 8: 2^21 lanes) and of
one G2 pass (2^15 points: 2^20 lanes), the least of PASS_REPS repeats a
stage, host clock after a synchronise at every mark; and
tools.prove_profile at PAYLOADS (the reference benchmark's MAX_PL), whose
"prove" rows run the prover as groth16.api.prove runs it PASS_REPS times
after a warm-up (a warm proof's host clock spreads by a quarter between
repeats: the table gives the least and the median).  The worker uses only
what both trees have.  Labels are matched with K8's " threads=..." taken
off.

Then cuobjdump -sass of each tree's library: for mont_chain_kernel (K6:
one product a loop step) and point_add_chain_kernel (K9: one complete G1
add a step) the loop body's instruction count, its IMAD-class count
(IMAD, IMAD.WIDE, IMAD.HI, IMAD.X, ...) and its critical path, the longest
chain of instructions each reading what the one before wrote (registers,
predicates: the carries).  K6's and K9's latency floors are their critical
paths times the latency of one dependent integer instruction: K7's u32mul
step on one warp over the critical path of one of its steps (its loop, 16
steps unrolled, read the same way: 2 a step).

The record is printed as one JSON line and written to --out (default
build/kernel_ab.json); a table of the cases goes to stdout.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

SEED = 20261016
ROOT = Path(__file__).resolve().parents[2]
CHAIN = (64, 256)
PAYLOADS = 20
PASS_REPS = 5

WORKER = r'''
import json, sys, time
import torch
from zklaim_tpu_torch import kernels as K
from zklaim_tpu_torch.kernels.cases import kernel_cases
from zklaim_tpu_torch.utils.profiling import best_ms, device_ms
from zklaim_tpu_torch.tools import (grid_micro, mont_micro, msm_stages, padd_micro,
                                    pallas_op_micro, prove_profile)

mode, seed, k1, k2 = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
payloads, reps = int(sys.argv[5]), int(sys.argv[6])
dev = torch.device("cuda:0")
K.library()
out = {"lib": K.BUILD_INFO["path"], "cases": {}, "probes": [], "one_warp_us_per_step": {}}
for c in kernel_cases(dev, seed=seed):
    if mode == "plain":
        if c.plain_once:
            torch.cuda.synchronize(); t0 = time.perf_counter(); c.plain(); torch.cuda.synchronize()
            out["cases"][c.label] = (time.perf_counter() - t0) * 1e3
        else:
            out["cases"][c.label] = best_ms(c.plain, dev)
    else:
        out["cases"][c.label] = device_ms(c.run)
if mode != "plain":
    for lanes in (1023, 1101, mont_micro.WIDE_LANES + 77):
        x = mont_micro.probe_input(lanes, dev)
        out["cases"][f"both trees: K6 mont_chain lanes={lanes} K=3"] = \
            device_ms(lambda: mont_micro.mont_chain(x, 3))
    for op in pallas_op_micro.OPS:
        v = pallas_op_micro.probe_input(op, pallas_op_micro.COLS, dev)
        k = pallas_op_micro.CHAIN[0]
        out["cases"][f"both trees: K7 op_chain {op} ({v.shape[0]}, {v.shape[1]}) K={k}"] = \
            device_ms(lambda: pallas_op_micro.op_chain(op, v, k))
    for tool in (mont_micro, pallas_op_micro, grid_micro, padd_micro):
        out["probes"] += tool.measure(dev)
    x = mont_micro.probe_input(32, dev)
    pt = padd_micro.probe_input(32, dev)
    v = torch.arange(1, 33, dtype=torch.int32, device=dev)
    for name, fn, f in (("mont_chain", lambda k: mont_micro.mont_chain(x, k), 1),
                        ("point_add_chain", lambda k: padd_micro.point_add_chain(pt, k), 1),
                        ("op_chain u32mul", lambda k: pallas_op_micro.op_chain("u32mul", v, k), 64)):
        t1, t2 = (best_ms(lambda: fn(f * k), dev, runs=5) for k in (k1, k2))
        out["one_warp_us_per_step"][name] = (t2 - t1) / (f * (k2 - k1)) * 1e3
    out["stages"] = (msm_stages.measure(dev, 16, runs=reps, deg=1)
                     + msm_stages.measure(dev, 15, runs=reps, deg=2))
    out["prove"] = [r for r in prove_profile.measure(dev, payloads, reps)
                    if r["group"].startswith("prove ")]
print("KERNEL_AB " + json.dumps(out))
'''

INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[0-9T]\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);")
NO_DEST = ("ST", "STG", "STS", "STL", "BRA", "EXIT", "BAR", "RED", "RET", "CALL", "NOP", "BSYNC",
           "BSSY", "WARPSYNC")


def run_worker(tree: Path, mode: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", WORKER, mode, str(SEED), *map(str, CHAIN),
                           str(PAYLOADS), str(PASS_REPS)],
                          cwd=tree, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"worker {mode} in {tree} failed:\n{proc.stderr[-4000:]}")
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("KERNEL_AB ")][-1]
    return json.loads(line[len("KERNEL_AB "):])


def sass_functions(lib: str) -> dict:
    """{function name: [(address, predicate, opcode, operand string)]} of a
    library's SASS."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, check=True).stdout
    return parse_sass(text)


def parse_sass(text: str) -> dict:
    funcs, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            cur = funcs.setdefault(line.split("Function :")[1].strip(), [])
        elif cur is not None and (m := INSTR.search(line)):
            cur.append((int(m[1], 16), (m[2] or "").strip(), m[3], m[4].strip()))
    return funcs


def loop_body(instrs: list) -> list:
    """The instructions of the widest loop: from a backward branch's target
    to the branch."""
    best = []
    for addr, _, op, args in instrs:
        if op.startswith("BRA") and (t := re.fullmatch(r"(0x[0-9a-f]+)", args.strip())):
            target = int(t[1], 16)
            if target < addr and addr - target > (best[-1][0] - best[0][0] if best else -1):
                best = [i for i in instrs if target <= i[0] <= addr]
    return best


def _operands(args: str) -> list:
    out, depth, cur = [], 0, ""
    for ch in args:
        depth += {"[": 1, "]": -1}.get(ch, 0)
        if ch == "," and depth == 0:
            out.append(cur.strip())
            cur = ""
        else:
            cur += ch
    return out + ([cur.strip()] if cur.strip() else [])


def _regs(operand: str, wide: bool = False) -> list:
    """Registers and predicates an operand names (RZ, PT, URZ excluded); a
    .64 address or a wide operand names a register pair."""
    found = []
    for name in re.findall(r"\b(U?R\d+|U?P\d)\b", operand):
        found.append(name)
        if (wide or ".64" in operand) and re.fullmatch(r"U?R\d+", name):
            base = re.match(r"U?R", name)[0]
            found.append(f"{base}{int(name[len(base):]) + 1}")
    return found


def critical_path(body: list) -> int:
    """Longest chain of dependent instructions in a loop body, each counted
    once: a read waits for the last write of that register or predicate
    (carry) earlier in the body."""
    ready, longest = {}, 0
    for _, pred, op, args in body:
        base = op.split(".")[0]
        ops = _operands(args)
        wide = ".WIDE" in op
        dests, srcs = [], _regs(pred)
        if ops and base not in NO_DEST:
            dests = _regs(ops[0], wide)
            rest = ops[1:]
            while rest and re.fullmatch(r"U?P\d|PT", rest[0]):
                dests += _regs(rest[0])
                rest = rest[1:]
            values = [i for i, o in enumerate(rest) if not re.fullmatch(r"!?U?P[0-9T]", o)]
            for i, o in enumerate(rest):                  # a wide op's addend is a pair
                srcs += _regs(o, wide and i == values[-1])
        else:
            for o in ops:
                srcs += _regs(o)
        depth = 1 + max((ready.get(r, 0) for r in srcs), default=0)
        for r in dests:
            ready[r] = depth
        longest = max(longest, depth)
    return longest


def loop_stats(funcs: dict, kernel: str) -> dict:
    name = next(n for n in funcs if kernel in n)
    body = loop_body(funcs[name])
    ops = [op for _, _, op, _ in body]
    return {"function": name, "instructions": len(ops),
            "imad_class": sum(op.startswith("IMAD") for op in ops),
            "critical_path": critical_path(body)}


def _label(label: str) -> str:
    return re.sub(r" threads=\d+", "", label)


def measure(other: Path) -> dict:
    this = ROOT
    runs = {"plain": run_worker(this, "plain")}
    order = [("other", other), ("this", this), ("this", this), ("other", other)]
    for i, (side, tree) in enumerate(order):
        runs[f"{i}:{side}"] = run_worker(tree, "kernels")
    rec = {"order": ["plain"] + [k for k in runs if k != "plain"], "cases": {}, "probes": {},
           "one_warp_us_per_step": {}, "passes": {}, "sass": {}}
    for key, run in runs.items():
        for label, ms in run["cases"].items():
            row = rec["cases"].setdefault(_label(label), {"plain_ms": None, "other": [], "this": []})
            if key == "plain":
                row["plain_ms"] = ms
            else:
                row[key.split(":")[1]].append(ms)
        if key != "plain":
            rec["probes"].setdefault(key, run["probes"])
            rec["one_warp_us_per_step"][key] = run["one_warp_us_per_step"]
            rec["passes"][key] = {"stages": run["stages"], "prove": run["prove"]}
    for side, key in (("other", "0:other"), ("this", "1:this")):
        funcs = sass_functions(runs[key]["lib"])
        rec["sass"][side] = {k: loop_stats(funcs, k) for k in
                             ("mont_chain_kernel", "point_add_chain_kernel", "op_chain_kernelILi0")}
    for side, keys in (("other", ("0:other", "3:other")), ("this", ("1:this", "2:this"))):
        sass = rec["sass"][side]
        best = {name: min(rec["one_warp_us_per_step"][k][name] for k in keys)
                for name in rec["one_warp_us_per_step"][keys[0]]}
        per_dep_ns = best["op_chain u32mul"] * 1e3 / (sass["op_chain_kernelILi0"]["critical_path"] / 16)
        sass["ns_per_dependent_instruction"] = per_dep_ns
        for kernel, key in (("mont_chain_kernel", "k6"), ("point_add_chain_kernel", "k9")):
            sass[f"{key}_latency_floor_us_per_step"] = sass[kernel]["critical_path"] * per_dep_ns / 1e3
        sass["one_warp_us_per_step"] = best
    return rec


def format_rows(rec: dict) -> list:
    rows = [f"{'case':80s} {'plain':>10s} {'other':>19s} {'this':>19s}"]
    for label, r in rec["cases"].items():
        fmt = lambda v: " / ".join(f"{x:.4f}" for x in v) if v else "-"
        plain = f"{r['plain_ms']:.3f}" if r["plain_ms"] is not None else "-"
        rows.append(f"{label[:80]:80s} {plain:>10s} {fmt(r['other']):>19s} {fmt(r['this']):>19s}")
    rows += pass_rows(rec["passes"])
    for side, s in rec["sass"].items():
        rows.append(f"SASS {side}: " + json.dumps(s))
    return rows


def pass_rows(passes: dict) -> list:
    """A line a kernel process: its G1 and G2 pass's upsweep, abel and all
    stages, and its warm proves' least and median."""
    rows = []
    for key, run in passes.items():
        stages = {(r["deg"], r["stage"]): r["ms"] for r in run["stages"]}
        total = {deg: sum(ms for (d, _), ms in stages.items() if d == deg) for deg in (1, 2)}
        proves = sorted(r["ms"] for r in run["prove"] if r["phase"] == "TOTAL")
        rows.append(f"{key:8s} G1 pass upsweep {stages[(1, 'upsweep')]:.3f} abel "
                    f"{stages[(1, 'abel')]:.3f} all {total[1]:.3f} ms; G2 pass upsweep "
                    f"{stages[(2, 'upsweep')]:.3f} abel {stages[(2, 'abel')]:.3f} all "
                    f"{total[2]:.3f} ms; warm prove at N = {PAYLOADS} least "
                    f"{proves[0]:.1f}, median {proves[len(proves) // 2]:.1f} ms")
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path, help="root of the other checkout")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "kernel_ab.json")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device; it compares kernels on a GPU")
    rec = measure(args.other.resolve())
    rec["device"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(rec, indent=1))
    print("\n".join(format_rows(rec)))
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
