#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (zklaim_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. Requires CUDA (exits non-zero without it) and prints the card's name
   and power limit.
2. Builds the kernels K1-K4 from zklaim_tpu_torch/csrc with nvcc.
3. Holds each kernel against its plain PyTorch version on the card, at the
   main path's shapes, limb for limb (tolerance 0: integer arithmetic),
   and times both with CUDA events.
4. Drives the credential main path on ZKlaimCircuit(1): one trusted setup,
   three proofs of different payloads, each verified by the host verifier;
   an unsatisfied predicate must raise, a wrong public input must not
   verify.  Launch counts are reset just before and read just after; every
   kernel must have launched.
5. Holds the card against the CPU on the small circuit: the same seed must
   give the same proving key and proof on both devices.
6. Prints the kernel table as one JSON line, then as the last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.

Any failure raises, and the script exits non-zero.  The full record goes
to build/chip_smoke.json.
"""

from __future__ import annotations

import json
import random
import subprocess
import sys
import time
from pathlib import Path

SEED = 20261016

KERNEL_ROWS = {
    "mont_mul": ("zklaim_tpu_torch/csrc/mont_mul.cu", "zklaim_tpu/ntt/pallas_ntt.py:63"),
    "ntt_local": ("zklaim_tpu_torch/csrc/ntt.cu", "zklaim_tpu/ntt/pallas_ntt.py:100"),
    "ntt_stage": ("zklaim_tpu_torch/csrc/ntt.cu", "zklaim_tpu/ntt/pallas_ntt.py:152"),
    "point_add": ("zklaim_tpu_torch/csrc/curve.cu", "zklaim_tpu/ec/pallas_curve.py:222"),
}


def _ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the card (CUDA events, warmed up)."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on a GPU")
    from zklaim_tpu_torch import kernels as K
    from zklaim_tpu_torch.entry import run_main_path, tiny_circuit
    from zklaim_tpu_torch.groth16.api import prove, setup
    from zklaim_tpu_torch.kernels.cases import kernel_cases, max_abs_err

    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card = smi
    print(f"device: {name}, count {count}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi, flush=True)                      # name, power limit as nvidia-smi gives them
    record = {"device": name, "count": count, "nvidia_smi": smi}

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    K.library()
    record["build_s"] = time.perf_counter() - t0
    record["ptxas"] = K.BUILD_INFO.get("ptxas", "")
    print(f"[{card}] build: {record['build_s']:.3f} s (nvcc {K.BUILD_INFO['seconds']:.3f} s)")
    for line in record["ptxas"].splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print("  ptxas:", line.split("ptxas info    :")[-1].strip())
    sys.stdout.flush()

    # -- 3. kernel vs plain at main-path shapes ----------------------------
    dev = torch.device("cuda:0")
    rows = {k: {"name": k, "route": "cuda", "source": s, "replaces": r, "launches": 0,
                "max_abs_err": 0, "ms": None, "plain_ms": None}
            for k, (s, r) in KERNEL_ROWS.items()}
    record["cases"] = []
    for case in kernel_cases(dev, seed=SEED):
        got, want = case.run(), case.plain()
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        ms, plain_ms = _ms(case.run, 20), _ms(case.plain, 3)
        print(f"[{card}] {case.label}: max_abs_err {err}, kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms", flush=True)
        record["cases"].append({"label": case.label, "max_abs_err": err,
                                "ms": ms, "plain_ms": plain_ms})
        if err != 0:
            raise AssertionError(f"{case.label}: kernel disagrees with plain version")
        row = rows[case.kernel]
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if row["ms"] is None:           # the first case of a kernel is its headline
            row["ms"], row["plain_ms"] = ms, plain_ms

    # -- 4. the main path ----------------------------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    res = run_main_path(dev, num_payloads=1, requests=3, seed=SEED)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    res["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    res["launches"] = launches
    record["main_path"] = res
    print(f"[{card}] main path {res['circuit']}: {res['num_vars']} vars, "
          f"{res['num_constraints']} constraints, m = {res['m']}")
    print(f"[{card}] setup {res['setup_s']:.3f} s; prove cold {res['prove_s'][0]:.3f} s, "
          f"warm {', '.join(f'{t:.3f}' for t in res['prove_s'][1:])} s; "
          f"verify {', '.join(f'{t:.3f}' for t in res['verify_s'])} s")
    print(f"[{card}] peak device memory {res['peak_mem_bytes']} B; launches {launches}",
          flush=True)
    if not all(res["verified"]) or len(res["verified"]) != 3:
        raise AssertionError(f"a proof did not verify: {res['verified']}")
    if not res["unsatisfied_rejected"]:
        raise AssertionError("an unsatisfied predicate was proved")
    if not res["wrong_input_rejected"]:
        raise AssertionError("a proof verified against a wrong public input")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    for k, v in launches.items():
        rows[k]["launches"] = v

    # -- 5. card vs CPU on the small circuit ----------------------------------
    cs, witness = tiny_circuit()
    keys = {d: setup(cs, random.Random(SEED), d) for d in ("cuda", "cpu")}
    for field in ("a_g1", "b_g1", "b_g2", "h_g1", "l_g1"):
        if not torch.equal(getattr(keys["cuda"][0], field).cpu(), getattr(keys["cpu"][0], field)):
            raise AssertionError(f"setup on the card and on the CPU differ in pk.{field}")
    if keys["cuda"][1].ic != keys["cpu"][1].ic:
        raise AssertionError("setup on the card and on the CPU differ in vk.ic")
    proofs = {}
    for d, (pk, _, qap) in keys.items():
        proofs[d] = prove(pk, qap, witness, random.Random(SEED))
    if proofs["cuda"] != proofs["cpu"]:
        raise AssertionError("proofs on the card and on the CPU differ")
    print(f"[{card}] small circuit: pk, vk and proof identical on card and CPU", flush=True)

    out = Path("build")
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(record, indent=1, default=str))
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    main()
