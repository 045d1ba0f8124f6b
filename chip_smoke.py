#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (zklaim_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. Requires CUDA (exits non-zero without it) and prints the card's name
   and power limit.
2. Builds the kernels K1-K9 and the whole-loop entries mont_pow (K1),
   msm_upsweep, msm_tails and msm_abel (K4) and msm_finish (K5) from
   zklaim_tpu_torch/csrc with nvcc,
   the sources side by side, and prints what ptxas says of every kernel
   (registers, stack, spill bytes) and one line a kernel with its
   registers; a stack frame or a spill in any kernel fails the run.  K2's
   two entries again on their own
   lines beside K2's cluster launch (cluster size, CTAs, threads, shared
   memory a CTA) at the credential path's 2^15 and the bench's 2^22, and
   K6's launch (CTAs, threads a CTA, one lane a thread) at the probe's two
   widths.
3. Probes phase: the four probes of the measuring path
   (zklaim_tpu_torch.tools.mont_micro, pallas_op_micro, grid_micro,
   padd_micro: kernels K6-K9), each at its original's shape and at a width that
   fills the card; K6's wide row is the 32-bit multiply-add rate the card
   sustains.  K6-K9 must have launched.
   Then holds each of the fourteen entries against its plain PyTorch version
   on the card, at the shapes its path gives it (K6 also at the width that
   fills the card; K2 and K3 also on the four-step NTT's batches of
   transforms), limb for limb and, for K7's f32fma, bit for bit
   (tolerance 0 throughout: integer arithmetic, and a plain f32fma that
   rounds once as the fused one does).  Each case is timed twice: a call as
   the paths make it (CUDA events around 20 wrapper calls: mostly the host's
   time where the kernel is short) and the card's own time (the replay of a
   CUDA graph that holds 10 captured calls, utils.profiling.device_ms); the
   floor of a wrapper call, a product of ONE element, is printed once, and
   beside it the floor of a launch on the card itself, the graph replay of
   K7 at k = 0 on one element, against which small cases are read (K7's
   headline runs the tool's chain of 20,000 steps for that reason), and
   K6 at the card's width at K = 0 and 2 beside a PyTorch copy of the same
   planes (x.clone()), the card's rate for those bytes.  The
   plain version is timed too (once where it takes seconds), and each case's
   bound is printed: the least time the card could take for the same work
   (kernels/cases.py), held against the device time, at the assumed and at
   the measured multiply-add rate.
4. Drives the Groth16 path below the credential layer on ZKlaimCircuit(1)
   (entry.run_main_path): one trusted setup, three proofs of different
   payloads, each verified by the host verifier; an unsatisfied predicate
   must raise, a wrong public input must not verify.
5. Drives the credential path a user would call (entry.run_credential_path,
   the three-role flow of `cli demo` through claims.api.Context) on
   ZKlaimCircuit(1): issuer (setup, sign, serialize), three holders (each a
   fresh context that imports the 10 MB proving key from bytes, checks
   every table point on the card, proves and blinds), verifier; then every
   way the flow must fail, each by its status code.  Prints the roles'
   seconds, the byte sizes, the peak device memory and the launch counts.
   For each of the two paths the launch counts are set to 0 just before and
   read just after.  A proof must launch mont_mul, ntt_local, ntt_stage,
   point_add, msm_upsweep, msm_tails, msm_abel and msm_finish and no
   point_double; a proof_generate on an imported pk exactly what
   _proof_launches derives from the key's dimensions, which for
   ZKlaimCircuit(1) must be 2 msm_finish (one a finish), 3 msm_tails and
   3 msm_abel (one each a pass: two G1 chunks and the G2 sum), 12
   msm_upsweep (four a pass), 7 ntt_local and 7 ntt_stage (one each a
   transform: K2 gathers the transform's rows itself) and 4 point_add (the
   sums of the two G1 chunks: no pass adds through point_add); the
   credential path's trusted_setup must launch mont_pow, once a batched
   inversion.  The pk, vk and proof sizes
   must equal SWEEP.csv's row for one payload.
5b. The same path at the reference benchmark's width, ZKlaimCircuit(20)
   (zklaim/main_benchmark.c's MAX_PL: 508,203 variables, m = 2^20, a 229.7
   MB proving key), one holder, every failure status (the references and
   predicates of payload 0 and of the last payload tampered with): the
   byte sizes must equal SWEEP.csv's row for 20 payloads, a proof_generate
   on an imported pk must launch what _proof_launches derives (80
   msm_tails and 80 msm_abel: 64 G1 chunks and 16 G2; 320 msm_upsweep,
   four a pass; 160 point_add, the chunk sums; 14 ntt_stage: two K3 passes
   a transform of 2^20), trusted_setup mont_pow.  Prints each role's
   seconds, the pk import's, the peak device memory and the launches beside
   phase 5's.
6. Holds the card against the CPU on the small circuit: the same seed must
   give the same proving key, verifying key and proof on both devices, as
   tensors and as serde bytes, and pk_from_bytes(pk_to_bytes(pk)) must
   return the same tables.
7. Bench phase: zklaim_tpu_torch.bench.bench_all on the card -- G1 and G2
   MSM and Fr NTT at 2^16 / 2^20 / 2^22 points, the prover rows through
   claims.api.Context, batched proving of 8 -- every row printed with its
   peak device memory.  Checks: the flat MSM equals msm_ladder on a 2^10
   prefix (G1 and G2), which is where point_double (K5) runs; intt(ntt(x)) =
   x at 2^16; every proof of a batched_prove verifies.  The six kernels of
   the paths and point_double must have launched.
7b. Multi-device phase: zklaim_tpu_torch.parallel on a world of one over
   NCCL (the script needs one card, and NCCL runs no two ranks on one
   card): sharded_msm of 2^20 G1 points over the 1-D and the (1, 1)
   host mesh, each equal to the local msm and the host's sum; ShardedNTT at
   2^15 and 2^22, from_transposed(ntt_t(x)) = NTTDomain.ntt(x) and
   intt_t(ntt_t(x)) = x, with ntt_t launching K2 twice and K3 once a pass
   (a batch of transforms is one launch); batched_prove of 8 on
   ZKlaimCircuit(1) over the mesh, byte for byte the 8 successive proves of
   one seed, each verified; entry.run_multichip (2^15 points, an NTT of
   2^15: the full widths ran just before) and tools.scaling_bench at S = 1.  Each time is printed beside its
   one-device counterpart; the launch counts are set to 0 before the phase
   and read after it.
8. The phase splits of prove (with h_pipeline split into its steps) and
   setup (tools.prove_profile, tools.setup_profile), of one MSM pass
   (tools.msm_stages) and of the transform at 2^15 and 2^22
   (tools.ntt_profile), printed.
9. Asserts that no jax module and no module of the JAX package was loaded.
10. Prints the total seconds, the kernel table as one JSON line, then as the
   last line {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.

No failure is caught: any phase that fails raises, and the script exits
non-zero.  The full record goes to build/chip_smoke.json.
"""

from __future__ import annotations

import csv
import json
import random
import re
import subprocess
import sys
import time
from pathlib import Path

SEED = 20261016
MAX_PL = 20        # zklaim/main_benchmark.c: the reference benchmark sweeps 1 ... MAX_PL payloads

KERNEL_ROWS = {
    "mont_mul": ("zklaim_tpu_torch/csrc/mont_mul.cu", "zklaim_tpu/ntt/pallas_ntt.py:63"),
    "ntt_local": ("zklaim_tpu_torch/csrc/ntt.cu", "zklaim_tpu/ntt/pallas_ntt.py:100"),
    "ntt_stage": ("zklaim_tpu_torch/csrc/ntt.cu", "zklaim_tpu/ntt/pallas_ntt.py:152"),
    "point_add": ("zklaim_tpu_torch/csrc/curve.cu", "zklaim_tpu/ec/pallas_curve.py:222"),
    "point_double": ("zklaim_tpu_torch/csrc/curve.cu", "zklaim_tpu/ec/pallas_curve.py:233"),
    "mont_pow": ("zklaim_tpu_torch/csrc/mont_mul.cu",
                 "zklaim_tpu/ntt/pallas_ntt.py:63 in the loop of zklaim_tpu/ff/montgomery.py:236"),
    "msm_upsweep": ("zklaim_tpu_torch/csrc/curve.cu",
                    "zklaim_tpu/ec/pallas_curve.py:222 through :369 (_padd_halves_soa) in the "
                    "loop of zklaim_tpu/msm/pippenger.py:317"),
    "msm_tails": ("zklaim_tpu_torch/csrc/curve.cu",
                  "zklaim_tpu/ec/pallas_curve.py:222 in the loop of "
                  "zklaim_tpu/msm/pippenger.py:337"),
    "msm_abel": ("zklaim_tpu_torch/csrc/curve.cu",
                 "zklaim_tpu/ec/pallas_curve.py:222 through :369 (_padd_halves_soa) in the "
                 "loop of zklaim_tpu/msm/pippenger.py:354"),
    "msm_finish": ("zklaim_tpu_torch/csrc/curve.cu",
                   "zklaim_tpu/ec/pallas_curve.py:233 and :222 in the loops of "
                   "zklaim_tpu/msm/pippenger.py:366"),
    "mont_chain": ("zklaim_tpu_torch/csrc/probes.cu", "tools/mont_micro.py:22"),
    "op_chain": ("zklaim_tpu_torch/csrc/probes.cu", "tools/pallas_op_micro.py:27"),
    "point_add_tiled": ("zklaim_tpu_torch/csrc/probes.cu", "tools/grid_micro.py:25"),
    "point_add_chain": ("zklaim_tpu_torch/csrc/probes.cu", "tools/padd_micro.py:24"),
}
TABLES = ("a_g1", "b_g1", "b_g2", "h_g1", "l_g1")


def _timed_once(fn):
    """(fn(), its milliseconds on the card): one call between CUDA events."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


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


def _require_launched(launches: dict, path: str, kernels) -> None:
    missing = [k for k in kernels if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels never launched on {path}: {missing}")


def _require_not_launched(launches: dict, path: str, kernels) -> None:
    ran = {k: launches[k] for k in kernels if launches.get(k, 0)}
    if ran:
        raise AssertionError(f"kernels that {path} must not launch: {ran}")


def _sweep_sizes(num_payloads: int) -> dict:
    """pk_B, vk_B and proof_B of SWEEP.csv's row for `num_payloads` (the JAX
    package's run of the reference's sweep: byte formats, the same on any
    device)."""
    with open(Path(__file__).resolve().parent / "SWEEP.csv", newline="") as fh:
        for row in csv.DictReader(fh):
            if int(row["num_payloads"]) == num_payloads:
                return {k: int(row[k]) for k in ("pk_B", "vk_B", "proof_B")}
    raise AssertionError(f"SWEEP.csv has no row for {num_payloads} payloads")


def _proof_launches(num_vars: int, num_primary: int, m: int, c: int = 8) -> dict:
    """The launches of one proof_generate on an imported pk, derived from the
    key's dimensions.  The sums (msm/pippenger.py:msm_many): the four G1 sums
    A, B1 (num_vars points), H (m - 1) and L (num_vars - num_primary - 1) as
    one batch, the G2 sum (num_vars) alone, padded as pippenger.padded_shape
    says: n2 points a sum, one pass, or whole chunks, one pass each.  A pass
    of L lanes launches msm_upsweep once a launch of its plan
    (msm/upsweep_plan.py:upsweep_plan(deg, log2 L): four at 2^21 and 2^20
    lanes), msm_tails once and msm_abel once a launch of its Abel plan
    (abel_plan(deg, B k2 W, k2 W): one at c = 8), and no point_add; a sum in
    chunks adds two point_add a chunk (tot and head); each sum finishes in
    one msm_finish.  The transforms (groth16/qap.py:h_coefficients): seven
    of m, each one ntt_local and one ntt_stage a pass of
    gpu_ntt.global_passes."""
    from zklaim_tpu_torch.msm.pippenger import padded_shape
    from zklaim_tpu_torch.msm.upsweep_plan import abel_plan, upsweep_plan
    from zklaim_tpu_torch.ntt.gpu_ntt import global_passes

    W = 256 // c
    out = {"msm_finish": 0, "msm_tails": 0, "msm_upsweep": 0, "msm_abel": 0, "point_add": 0}
    for deg, lengths in ((1, (num_vars, num_vars, m - 1, num_vars - num_primary - 1)),
                         (2, (num_vars,))):
        k2, n2, chunk = padded_shape(deg, lengths, c)
        passes, width = (1, n2) if n2 <= chunk else (n2 // chunk, chunk)
        lanes = k2 * W * width
        out["msm_finish"] += 1
        out["msm_tails"] += passes
        out["msm_abel"] += passes * len(abel_plan(deg, (k2 * W) << (c - 1), k2 * W))
        out["msm_upsweep"] += passes * len(upsweep_plan(deg, lanes.bit_length() - 1))
        out["point_add"] += 2 * passes if passes > 1 else 0
    out["ntt_local"] = 7
    out["ntt_stage"] = 7 * len(global_passes(m))
    return out


def _ptxas_table(ptxas: str) -> dict:
    """{entry: {"registers", "stack", "spill_stores", "spill_loads"}} of every
    kernel ptxas compiled."""
    table, entry = {}, None
    for line in ptxas.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
            table[entry] = {}
        elif entry is None:
            continue
        elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                            r"(\d+) bytes spill loads", line):
            table[entry].update(stack=int(m[1]), spill_stores=int(m[2]), spill_loads=int(m[3]))
        elif m := re.search(r"Used (\d+) registers", line):
            table[entry]["registers"] = int(m[1])
    return table


def _kernel_name(entry: str) -> str:
    """The name inside a mangled entry (_Z16mont_chain_kernel... ->
    mont_chain_kernel), with the mangled one where there are template
    arguments."""
    m = re.match(r"_Z(\d+)", entry)
    if not m:
        return entry
    name = entry[m.end() : m.end() + int(m[1])]
    return f"{name} ({entry})" if entry[m.end() + int(m[1]) :].startswith("I") else name


def _check_credential(res: dict, what: str) -> None:
    """The checks phases 5 and 5b hold a run_credential_path result to: every
    status as expected, the byte sizes SWEEP.csv's, a proof_generate on an
    imported pk launching what _proof_launches derives from the key's
    dimensions, the path's kernels launched over the path and point_double
    not, trusted_setup launching mont_pow."""
    from zklaim_tpu_torch import kernels as K

    if not res["statuses_ok"]:
        raise AssertionError(f"{what}: status codes {res['status']} != expected {res['expected']}")
    sizes = {"pk_B": res["pk_bytes"], "vk_B": res["vk_bytes"], "proof_B": res["proof_bytes"]}
    if sizes != _sweep_sizes(res["num_payloads"]):
        raise AssertionError(f"{what}: byte sizes {sizes} != SWEEP.csv's "
                             f"{_sweep_sizes(res['num_payloads'])}")
    got = {k: res["reprove_launches"][k] for k in res["derived_proof_launches"]}
    if got != res["derived_proof_launches"]:
        raise AssertionError(f"{what}: proof_generate on an imported pk launched {got}, "
                             f"derived {res['derived_proof_launches']}")
    if got["point_add"] > 2 * got["msm_tails"] or got["msm_upsweep"] > 4 * got["msm_tails"]:
        raise AssertionError(f"{what}: a pass launched point_add or more than four msm_upsweep: "
                             f"{got}")
    _require_launched(res["launches"], what, K.PATH_KERNELS)
    _require_not_launched(res["launches"], what, ("point_double",))
    _require_launched(res["trusted_setup_launches"], f"{what}'s trusted_setup", ("mont_pow",))


def _wide_credential_phase(dev, card: str, narrow: dict) -> dict:
    """Phase 5b: entry.run_credential_path on ZKlaimCircuit(MAX_PL), one
    holder, every failure status (payload 0 and the last one tampered
    with); each figure printed beside phase 5's (`narrow`, ZKlaimCircuit(1)),
    then held by _check_credential.  The launch counts are set to 0 before
    the phase and read after it."""
    import torch

    from zklaim_tpu_torch import kernels as K
    from zklaim_tpu_torch.entry import run_credential_path

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    res = run_credential_path(dev, num_payloads=MAX_PL, requests=1, seed=SEED)
    torch.cuda.synchronize()
    res["phase_s"] = time.perf_counter() - t0
    res["launches"] = dict(K.LAUNCHES)
    res["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    res["derived_proof_launches"] = _proof_launches(res["num_vars"], res["num_primary"], res["m"])
    if res["derived_proof_launches"] != {"msm_finish": 2, "msm_tails": 80, "msm_upsweep": 320,
                                         "msm_abel": 80, "ntt_local": 7, "ntt_stage": 14,
                                         "point_add": 160}:
        raise AssertionError(f"ZKlaimCircuit({MAX_PL}): the derived launches "
                             f"{res['derived_proof_launches']} moved")
    print(f"[{card}] run_credential_path ZKlaimCircuit({MAX_PL}), 1 holder: "
          f"{res['num_vars']} variables, {res['num_primary']} primary, m = {res['m']}; "
          f"phase {res['phase_s']:.3f} s; beside it ZKlaimCircuit(1) (phase 5) in brackets")
    for key in ("issuer_s", "trusted_setup_s", "pk_import_s", "reprove_s"):
        print(f"[{card}]   {key} {res[key]:.3f} s [{narrow[key]:.3f}]")
    for key in ("holder_s", "proof_generate_s", "verifier_s"):
        print(f"[{card}]   {key} {res[key][0]:.3f} s [{narrow[key][0]:.3f}]")
    for key in ("pk_bytes", "vk_bytes", "proof_bytes", "peak_mem_bytes"):
        print(f"[{card}]   {key} {res[key]} B [{narrow[key]}]")
    for key in ("launches", "trusted_setup_launches", "reprove_launches", "pk_import_launches"):
        print(f"[{card}]   {key} " + ", ".join(f"{k} {res[key][k]} [{narrow[key][k]}]"
                                              for k in K.PATH_KERNELS))
    print(f"[{card}]   proof_generate on an imported pk, derived "
          f"{res['derived_proof_launches']}", flush=True)
    _check_credential(res, f"run_credential_path ZKlaimCircuit({MAX_PL})")
    return res


def _multi_device_phase(dev, card: str, credential) -> dict:
    """parallel/ on a world of one over NCCL (a file:// store in a temporary
    directory): sharded_msm of 2^20 G1 points over the 1-D and the (1, 1)
    host mesh against the local msm and the host's sum; ShardedNTT at 2^15
    and 2^22 against NTTDomain (from_transposed(ntt_t(x)) = ntt(x),
    intt_t(ntt_t(x)) = x), its batched K2 / K3 counted; batched_prove of 8
    on ZKlaimCircuit(1) over the mesh against 8 successive proves from one
    seed, byte for byte, each verified; run_multichip and scaling_bench at
    S = 1.  Each time beside its one-device counterpart (host clock between
    synchronises, least of 3 after a warm-up).  The launch counts are set to
    0 before the phase and read after it."""
    import tempfile

    import torch
    import torch.distributed as dist

    from zklaim_tpu_torch import kernels as K
    from zklaim_tpu_torch.claims import serde
    from zklaim_tpu_torch.ec import curve as C
    from zklaim_tpu_torch.entry import (multiple_rows, multiple_rows_sum, random_scalars,
                                        run_multichip)
    from zklaim_tpu_torch.ff import montgomery as M
    from zklaim_tpu_torch.groth16.api import prove, verify
    from zklaim_tpu_torch.msm.pippenger import msm
    from zklaim_tpu_torch.ntt import gpu_ntt
    from zklaim_tpu_torch.ntt.radix2 import get_domain
    from zklaim_tpu_torch.parallel import mesh as MESH
    from zklaim_tpu_torch.parallel.msm import sharded_msm
    from zklaim_tpu_torch.parallel.ntt import ShardedNTT
    from zklaim_tpu_torch.parallel.prove import batched_prove
    from zklaim_tpu_torch.tools import scaling_bench
    import numpy as np

    def best_s(fn, reps=3):
        fn()
        best = float("inf")
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        return best

    res = {"seconds": {}}
    torch.cuda.synchronize()
    K.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        if not MESH.init_distributed(f"file://{tmp}/store", 1, 0, device=dev):
            raise AssertionError("the process group was not set up")
        try:
            res["backend"] = dist.get_backend()
            if res["backend"] != "nccl":
                raise AssertionError(f"a CUDA world on {res['backend']}, not NCCL")
            mesh, hmesh = MESH.make_mesh(), MESH.make_host_mesh()
            res["host_mesh"] = list(hmesh.devices.shape)

            n = 1 << 20
            t0 = time.perf_counter()
            rows, k = multiple_rows(n, dev)
            scalars = random_scalars(n, np.random.default_rng(SEED), dev)
            host = multiple_rows_sum(k, scalars)
            res["seconds"]["msm_inputs_host"] = time.perf_counter() - t0
            got = {"local msm": msm(1, rows, scalars),
                   "sharded_msm 1-D": sharded_msm(mesh, 1, rows, scalars),
                   "sharded_msm (1, 1) host mesh": sharded_msm(hmesh, 1, rows, scalars,
                                                               axis=("host", "chip"))}
            for what, pt in got.items():
                if C.planes_to_host_points(1, pt)[0] != host:
                    raise AssertionError(f"{what} of 2^20 points differs from the host's sum")
            res["seconds"]["msm_2^20"] = {
                "local msm": best_s(lambda: msm(1, rows, scalars)),
                "sharded_msm 1-D": best_s(lambda: sharded_msm(mesh, 1, rows, scalars)),
                "sharded_msm (1, 1) host mesh": best_s(lambda: sharded_msm(
                    hmesh, 1, rows, scalars, axis=("host", "chip")))}
            print(f"[{card}] multi-device (NCCL, world of one): 2^20 G1 points, local msm, "
                  f"sharded 1-D and (1, 1) host mesh all equal the host's sum; seconds "
                  f"{json.dumps(res['seconds']['msm_2^20'])}", flush=True)
            del rows, scalars

            res["ntt"] = {}
            for log2n in (15, 22):
                m = 1 << log2n
                dom = get_domain(m, str(dev))
                x = M.to_mont(M.FR, random_scalars(m, np.random.default_rng(log2n), dev))
                plan = ShardedNTT(mesh, m)
                before = dict(K.LAUNCHES)
                z = plan.ntt_t(plan.to_matrix(x))
                torch.cuda.synchronize()
                counts = {kk: K.LAUNCHES[kk] - before[kk] for kk in ("ntt_local", "ntt_stage")}
                want = {"ntt_local": 2,
                        "ntt_stage": len(gpu_ntt.global_passes(plan.n1, batch=plan.cols))
                        + len(gpu_ntt.global_passes(plan.n2, batch=plan.rows))}
                if counts != want:
                    raise AssertionError(f"ntt_t at 2^{log2n} launched {counts}, expected {want}: "
                                         f"a batch is one K2 launch and one K3 a pass")
                if not torch.equal(plan.from_transposed(z), dom.ntt(x)):
                    raise AssertionError(f"from_transposed(ntt_t(x)) != ntt(x) at 2^{log2n}")
                if not torch.equal(plan.intt_t(z).reshape(m, 16), x):
                    raise AssertionError(f"intt_t(ntt_t(x)) != x at 2^{log2n}")
                xm = plan.to_matrix(x)
                res["ntt"][log2n] = {
                    "split": [plan.n1, plan.n2], "launches_ntt_t": counts,
                    "ntt_t_s": best_s(lambda: plan.ntt_t(xm)),
                    "round_trip_s": best_s(lambda: plan.intt_t(plan.ntt_t(xm))),
                    "NTTDomain.ntt_s": best_s(lambda: dom.ntt(x)),
                    "NTTDomain_round_trip_s": best_s(lambda: dom.intt(dom.ntt(x)))}
                print(f"[{card}] multi-device: ShardedNTT 2^{log2n} ({plan.n1} x {plan.n2}) = "
                      f"NTTDomain.ntt, round trip = x; {json.dumps(res['ntt'][log2n])}",
                      flush=True)

            cs, pk, vk, qap, witness, primary = credential
            batch = [witness] * 8
            prove(pk, qap, witness, random.Random(SEED))            # warm-up
            t0 = time.perf_counter()
            rng = random.Random(SEED)
            one_by_one = [serde.proof_to_bytes(prove(pk, qap, w, rng)) for w in batch]
            torch.cuda.synchronize()
            res["seconds"]["8 successive prove"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            proofs = batched_prove(mesh, pk, qap, batch, random.Random(SEED))
            torch.cuda.synchronize()
            res["seconds"]["batched_prove of 8 over the mesh"] = time.perf_counter() - t0
            if [serde.proof_to_bytes(p) for p in proofs] != one_by_one:
                raise AssertionError("batched_prove over the mesh differs from successive proves")
            if not all(verify(vk, primary, p) for p in proofs):
                raise AssertionError("a proof of batched_prove over the mesh did not verify")
            print(f"[{card}] multi-device: batched_prove of 8 on ZKlaimCircuit(1) = 8 successive "
                  f"proves, byte for byte, all verify; batched "
                  f"{res['seconds']['batched_prove of 8 over the mesh']:.3f} s, successive "
                  f"{res['seconds']['8 successive prove']:.3f} s (after a warm-up)",
                  flush=True)

            # the full widths ran above; here the entry point itself, at the
            # credential circuit's m
            mc = run_multichip(mesh, n_points=1 << 15, ntt_n=1 << 15, msm_c=8, seed=SEED)
            res["run_multichip"] = {"seconds": mc["seconds"], "verified": mc["verified"],
                                    "host_mesh": list(mc["host_mesh"])}
            print(f"[{card}] run_multichip (2^15 points, NTT 2^15, tiny circuit): "
                  f"{json.dumps(res['run_multichip'])}", flush=True)
            sb = scaling_bench.measure(dev, log2n=20)
            scaling_bench.write(sb)
            res["scaling_bench"] = sb
            for row in sb["msm"] + sb["ntt"]:
                print(f"[{card}] scaling_bench {json.dumps(row)}", flush=True)
        finally:
            MESH.shutdown_distributed()
    torch.cuda.synchronize()
    res["launches"] = dict(K.LAUNCHES)
    print(f"[{card}] multi-device phase launches {res['launches']}", flush=True)
    _require_launched(res["launches"], "the multi-device phase",
                      ("mont_mul", "ntt_local", "ntt_stage", "point_add", "msm_upsweep",
                       "msm_tails", "msm_abel", "msm_finish"))
    return res


def main() -> None:
    t_start = time.perf_counter()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on a GPU")
    from zklaim_tpu_torch import kernels as K
    from zklaim_tpu_torch.claims import serde
    from zklaim_tpu_torch.ec import curve as C
    from zklaim_tpu_torch.entry import run_credential_path, run_main_path, tiny_circuit
    from zklaim_tpu_torch.ff import montgomery as M
    from zklaim_tpu_torch.groth16.api import prove, setup
    from zklaim_tpu_torch import bench
    from zklaim_tpu_torch.groth16.api import verify
    from zklaim_tpu_torch.kernels.cases import (
        INT32_MAD_PER_S, bound_ms, kernel_cases, max_abs_err,
    )
    from zklaim_tpu_torch.msm.pippenger import msm_ladder, msm_pow2
    from zklaim_tpu_torch.ntt import gpu_ntt
    from zklaim_tpu_torch.ntt.radix2 import get_domain
    from zklaim_tpu_torch.parallel.prove import batched_prove
    from zklaim_tpu_torch.tools import (
        grid_micro, mont_micro, msm_stages, ntt_profile, padd_micro, pallas_op_micro,
        prove_profile, setup_profile,
    )
    from zklaim_tpu_torch.utils.profiling import device_ms

    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card = smi
    print(f"device: {name}, count {count}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi, flush=True)
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
    record["ptxas_table"] = _ptxas_table(record["ptxas"])
    for entry, info in record["ptxas_table"].items():
        print(f"[{card}] ptxas {_kernel_name(entry)}: {info.get('registers')} registers, "
              f"{info.get('stack')} bytes stack frame, {info.get('spill_stores')} / "
              f"{info.get('spill_loads')} bytes spill stores / loads")
    faults = {e: i for e, i in record["ptxas_table"].items()
              if set(i) != {"registers", "stack", "spill_stores", "spill_loads"}
              or i["stack"] or i["spill_stores"] or i["spill_loads"]}
    if faults or not record["ptxas_table"]:
        raise AssertionError(f"kernels with a stack frame or spills (or no ptxas line): {faults}")
    record["k2_ptxas"] = {e: i for e, i in record["ptxas_table"].items() if "ntt_local_kernel" in e}
    for entry, info in record["k2_ptxas"].items():
        print(f"[{card}] K2 {entry}: {info['registers']} registers, {info['stack']} bytes stack frame")
    record["k2_launch"] = {n: gpu_ntt.local_launch(n) for n in (1 << 15, 1 << 22)}
    for n, cfg in record["k2_launch"].items():
        print(f"[{card}] K2 launch at n = 2^{n.bit_length() - 1}: clusters of {cfg['cluster']} CTAs, "
              f"{cfg['ctas']} CTAs of {cfg['threads']} threads, {cfg['shared_bytes']} B of "
              f"shared memory a CTA")
    dev = torch.device("cuda:0")
    sms = K.sm_count(dev)
    record["k6_plan"] = {n: {"threads": mont_micro.chain_threads(n, sms)}
                         for n in (mont_micro.LANES, mont_micro.WIDE_LANES)}
    for n, plan in record["k6_plan"].items():
        plan["ctas"] = -(-n // plan["threads"])
        print(f"[{card}] K6 launch at {n} lanes ({sms} SMs): {plan['ctas']} CTAs of "
              f"{plan['threads']} threads, one lane a thread, 0 B of shared memory a CTA")
    sys.stdout.flush()

    # -- 3a. probes phase: K6-K9 through their tools ------------------------
    rows = {k: {"name": k, "route": "cuda", "source": s, "replaces": r, "launches": 0,
                "max_abs_err": 0, "ms": None, "device_ms": None, "plain_ms": None,
                "bound_ms": None, "bound_by": None, "library_ms": None}
            for k, (s, r) in KERNEL_ROWS.items()}
    torch.cuda.synchronize()
    K.reset_launches()
    record["probes"] = []
    for tool in (mont_micro, pallas_op_micro, grid_micro, padd_micro):
        for row in tool.measure(dev):
            record["probes"].append(row)
            print(tool.format_row(row), flush=True)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    print(f"[{card}] probes phase launches {launches}")
    _require_launched(launches, "the probes phase", K.PROBE_KERNELS)
    for k in K.PROBE_KERNELS:
        rows[k]["launches"] = launches[k]
    wide = [r for r in record["probes"] if r["kernel"] == "mont_chain"][-1]
    measured_mads = wide["mads_per_s"]
    record["measured_mads_per_s"] = measured_mads
    print(f"[{card}] 32-bit multiply-adds in Montgomery products: measured "
          f"{measured_mads / 1e12:.3f} T/s (K6, {wide['lanes']} lanes) against the assumed "
          f"{INT32_MAD_PER_S / 1e12:.2f} T/s", flush=True)

    # -- 3b. kernel vs plain at the paths' shapes ----------------------------
    one = torch.zeros((1, 16), dtype=torch.int32, device=dev)
    record["wrapper_floor_ms"] = _ms(lambda: M.mont_mul(M.FR, one, one), 200)
    print(f"[{card}] floor of a wrapper call (mont_mul on one element, CUDA events around 200 "
          f"calls): {record['wrapper_floor_ms']:.4f} ms", flush=True)
    v1 = torch.ones(1, dtype=torch.int32, device=dev)
    record["launch_floor_device_ms"] = device_ms(lambda: pallas_op_micro.op_chain("u32mul", v1, 0))
    print(f"[{card}] floor of a launch on the card (K7 at k = 0 on one element, graph replay): "
          f"{record['launch_floor_device_ms']:.4f} ms", flush=True)
    xw = mont_micro.probe_input(mont_micro.WIDE_LANES, dev)
    record["k6_bytes_ms"] = {"K6 K=0": device_ms(lambda: mont_micro.mont_chain(xw, 0)),
                             "K6 K=2": device_ms(lambda: mont_micro.mont_chain(xw, 2)),
                             "x.clone()": device_ms(lambda: xw.clone())}
    print(f"[{card}] K6's bytes at {mont_micro.WIDE_LANES} lanes (graph replay, ms): "
          f"{json.dumps(record['k6_bytes_ms'])}", flush=True)
    del xw
    record["cases"] = []
    for case in kernel_cases(dev, seed=SEED):
        if case.plain_once:              # seconds a call: the comparison's own run is the timing
            got = case.run()
            want, plain_ms = _timed_once(case.plain)
        else:
            got, want = case.run(), case.plain()
            plain_ms = _ms(case.plain, 3)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        ms, dev_ms = _ms(case.run, 20), device_ms(case.run)
        bound, bound_by = bound_ms(case)
        bound_m, bound_m_by = bound_ms(case, measured_mads)
        print(f"[{card}] {case.label}: max_abs_err {err}, call {ms:.4f} ms, device {dev_ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {bound:.4g} ms by {bound_by} "
              f"({100 * bound / dev_ms:.2f} % of the device time); at the measured multiply-add "
              f"rate {bound_m:.4g} ms by {bound_m_by} ({100 * bound_m / dev_ms:.2f} %)", flush=True)
        record["cases"].append({"label": case.label, "max_abs_err": err,
                                "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                                "bound_ms": bound, "bound_by": bound_by,
                                "bound_measured_rate_ms": bound_m,
                                "bound_measured_rate_by": bound_m_by})
        if err != 0:
            raise AssertionError(f"{case.label}: kernel disagrees with plain version")
        row = rows[case.kernel]
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row.setdefault("entries", []).append(
            {"label": case.label, "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
             "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by})
        if row["ms"] is None:           # the first case of a kernel is its headline
            row.update(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound,
                       bound_by=bound_by)

    # -- 4. the Groth16 path below the credential layer ----------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    res = run_main_path(dev, num_payloads=1, requests=3, seed=SEED)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    res["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    res["launches"] = launches
    record["main_path"] = res
    print(f"[{card}] run_main_path {res['circuit']}: {res['num_vars']} vars, "
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
    _require_launched(launches, "run_main_path", K.PROOF_KERNELS)
    _require_not_launched(launches, "run_main_path", ("point_double",))
    for k in K.PATH_KERNELS + ("point_double",):
        rows[k]["launches_run_main_path"] = launches[k]

    # -- 5. the credential path through claims.api.Context -------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    cred = run_credential_path(dev, num_payloads=1, requests=3, seed=SEED)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    cred["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    cred["launches"] = launches
    record["credential_path"] = cred
    print(f"[{card}] run_credential_path ZKlaimCircuit(1), 3 holders; signing: {cred['signing']}")
    print(f"[{card}] issuer {cred['issuer_s']:.3f} s (trusted_setup {cred['trusted_setup_s']:.3f} s); "
          f"holder {', '.join(f'{t:.3f}' for t in cred['holder_s'])} s "
          f"(proof_generate with pk import: cold {cred['proof_generate_s'][0]:.3f} s, "
          f"warm {', '.join(f'{t:.3f}' for t in cred['proof_generate_s'][1:])} s; "
          f"pk import alone {cred['pk_import_s']:.3f} s; proof_generate on an imported pk "
          f"{cred['reprove_s']:.3f} s); "
          f"verifier {', '.join(f'{t:.3f}' for t in cred['verifier_s'])} s")
    print(f"[{card}] pk {cred['pk_bytes']} B, vk {cred['vk_bytes']} B, proof {cred['proof_bytes']} B; "
          f"peak device memory {cred['peak_mem_bytes']} B")
    print(f"[{card}] launches over the path {launches}; trusted_setup "
          f"{cred['trusted_setup_launches']}; proof_generate with pk import "
          f"{cred['proof_generate_launches'][-1]}; proof_generate on an imported pk "
          f"{cred['reprove_launches']}; pk import {cred['pk_import_launches']}")
    print(f"[{card}] status codes {cred['status']}", flush=True)
    # one msm_finish a finish, one msm_tails and one msm_abel a pass, four
    # msm_upsweep a pass, point_add only for the chunk sums, one ntt_stage a transform
    cred["derived_proof_launches"] = _proof_launches(cred["num_vars"], cred["num_primary"],
                                                     cred["m"])
    if cred["derived_proof_launches"] != {"msm_finish": 2, "msm_tails": 3, "msm_upsweep": 12,
                                          "msm_abel": 3, "ntt_local": 7, "ntt_stage": 7,
                                          "point_add": 4}:
        raise AssertionError(f"ZKlaimCircuit(1): the derived launches "
                             f"{cred['derived_proof_launches']} moved")
    _check_credential(cred, "run_credential_path")
    if cred["status"]["verify"] != [0, 0, 0]:
        raise AssertionError(f"three verified proofs expected: {cred['status']['verify']}")
    _require_launched(cred["reprove_launches"], "proof_generate", K.PROOF_KERNELS)
    if cred["trusted_setup_launches"]["mont_mul"] > 100:
        raise AssertionError(f"trusted_setup: the inversions' squarings are mont_pow's now, yet "
                             f"mont_mul launched {cred['trusted_setup_launches']['mont_mul']} times")
    for k in K.PATH_KERNELS + ("point_double",):
        rows[k]["launches"] = launches[k]
        rows[k]["launches_proof_generate"] = cred["reprove_launches"][k]
        rows[k]["launches_trusted_setup"] = cred["trusted_setup_launches"][k]

    # -- 5b. the credential path at the reference benchmark's width: MAX_PL payloads
    wide = _wide_credential_phase(dev, card, cred)
    record["credential_path_n20"] = wide
    for k in K.PATH_KERNELS:
        rows[k]["launches_n20"] = wide["launches"][k]
        rows[k]["launches_proof_generate_n20"] = wide["reprove_launches"][k]

    # -- 6. card vs CPU on the small circuit, as tensors and as bytes ---------
    cs, witness = tiny_circuit()
    keys = {d: setup(cs, random.Random(SEED), d) for d in ("cuda", "cpu")}
    for field in TABLES:
        if not torch.equal(getattr(keys["cuda"][0], field).cpu(), getattr(keys["cpu"][0], field)):
            raise AssertionError(f"setup on the card and on the CPU differ in pk.{field}")
    if keys["cuda"][1].ic != keys["cpu"][1].ic:
        raise AssertionError("setup on the card and on the CPU differ in vk.ic")
    proofs, raw = {}, {}
    for d, (pk, vk, qap) in keys.items():
        proofs[d] = prove(pk, qap, witness, random.Random(SEED))
        raw[d] = (serde.pk_to_bytes(pk, 0), serde.vk_to_bytes(vk), serde.proof_to_bytes(proofs[d]))
    if proofs["cuda"] != proofs["cpu"]:
        raise AssertionError("proofs on the card and on the CPU differ")
    for what, on_card, on_cpu in zip(("pk", "vk", "proof"), raw["cuda"], raw["cpu"]):
        if on_card != on_cpu:
            raise AssertionError(f"{what} bytes on the card and on the CPU differ")
    back, _ = serde.pk_from_bytes(raw["cuda"][0], dev)
    again = serde.pk_to_bytes(back, 0)
    if again != raw["cuda"][0]:
        raise AssertionError("pk_to_bytes(pk_from_bytes(b)) != b on the card")
    # an imported table is the affine form (Z = 1) of the setup's: equal as points
    for field in TABLES:
        deg = 2 if field == "b_g2" else 1
        if (C.planes_to_host_points(deg, C.rows_to_planes(getattr(back, field)))
                != C.planes_to_host_points(deg, C.rows_to_planes(getattr(keys["cuda"][0], field)))):
            raise AssertionError(f"pk_from_bytes(pk_to_bytes(pk)) differs from pk in {field}")
    print(f"[{card}] small circuit: pk, vk and proof identical on card and CPU, as tensors "
          f"and as bytes ({len(raw['cuda'][0])} B pk); pk bytes round trip on the card",
          flush=True)

    # -- 7. bench phase: bench_all at the original's sizes ---------------------
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    bench.bench_all(str(Path("build") / "bench_all.json"), dev)     # prints each row (stderr)
    torch.cuda.synchronize()
    record["bench"] = json.loads((Path("build") / "bench_all.json").read_text())
    for row in record["bench"]:
        print(f"[{card}] bench {json.dumps(row)}")
    print(f"[{card}] bench_all {time.perf_counter() - t0:.1f} s; launches {dict(K.LAUNCHES)}",
          flush=True)
    if len(record["bench"]) != 18:
        raise AssertionError(f"bench_all gave {len(record['bench'])} rows, 18 expected")

    nrng = np.random.default_rng(SEED)

    def limbs(n, top):           # (n, 16) canonical limbs of values below top * 2^240
        v = nrng.integers(0, 1 << 16, size=(n, 16))
        v[:, 15] = nrng.integers(0, top, size=n)
        return torch.from_numpy(v.astype(np.int32)).to(dev)

    for deg in (1, 2):
        pts, sc = bench.make_points(deg, 1 << 10, dev), limbs(1 << 10, 0x2000)
        flat = C.planes_to_host_points(deg, msm_pow2(deg, pts, sc))[0]
        ladder = C.planes_to_host_points(deg, msm_ladder(deg, pts, sc))[0]
        if flat != ladder:
            raise AssertionError(f"G{deg}: the flat MSM and msm_ladder differ on 2^10 points")
    dom = get_domain(1 << 16, str(dev))
    x = limbs(1 << 16, 0x3064)                    # below r: its top limb is 0x3064
    if not torch.equal(dom.intt(dom.ntt(x)), x):
        raise AssertionError("intt(ntt(x)) != x at 2^16")
    circ_rng = random.Random(SEED)
    ctx = bench.demo_context(circ_rng, dev)
    from zklaim_tpu_torch.claims.circuit import ZKlaimCircuit

    circ = ZKlaimCircuit(1)
    pk1, vk1, qap1 = setup(circ.cs, circ_rng, dev)
    inputs = [(pl.pre, pl.data_ref, pl.op_positions()) for pl in ctx.payloads]
    batch = batched_prove(None, pk1, qap1, [circ.witness(inputs)] * 3, circ_rng)
    if len(batch) != 3 or not all(verify(vk1, circ.public_inputs(inputs), pr) for pr in batch):
        raise AssertionError("a proof of batched_prove did not verify")
    print(f"[{card}] checks: flat MSM = msm_ladder on 2^10 points (G1, G2); intt(ntt(x)) = x "
          f"at 2^16; 3 proofs of batched_prove verify", flush=True)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    print(f"[{card}] bench phase with its checks: launches {launches}", flush=True)
    _require_launched(launches, "the bench phase", K.PATH_KERNELS + ("point_double",))
    for k in K.PATH_KERNELS + ("point_double",):
        rows[k]["launches_bench"] = launches[k]
    rows["point_double"]["launches"] = launches["point_double"]     # its path is msm_ladder's

    # -- 7b. the multi-device path: a world of one over NCCL ----------------------
    record["multi_device"] = _multi_device_phase(dev, card, (circ.cs, pk1, vk1, qap1,
                                                             circ.witness(inputs),
                                                             circ.public_inputs(inputs)))
    for k in K.PATH_KERNELS:
        rows[k]["launches_multi_device"] = record["multi_device"]["launches"][k]

    # -- 8. phase splits of prove, setup and one MSM pass -------------------------
    record["prove_profile"] = prove_profile.measure(dev)
    print("\n".join(prove_profile.format_rows(record["prove_profile"])))
    record["setup_profile"] = setup_profile.measure(dev)
    print("\n".join(setup_profile.format_rows(record["setup_profile"])))
    record["msm_stages"] = []
    for deg, log2n in ((1, 16), (2, 15)):
        stage_rows = msm_stages.measure(dev, log2n, deg=deg)
        record["msm_stages"] += stage_rows
        print("\n".join(msm_stages.format_rows(stage_rows)))
    record["ntt_profile"] = ntt_profile.measure(dev)
    print("\n".join(ntt_profile.format_rows(record["ntt_profile"])))
    sys.stdout.flush()

    # -- 9. nothing of jax or the JAX package was loaded -----------------------
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "zklaim_tpu"))
    if foreign:
        raise AssertionError(f"jax / JAX-package modules loaded: {foreign}")
    print(f"[{card}] no jax and no zklaim_tpu module loaded")

    out = Path("build")
    out.mkdir(exist_ok=True)
    record["total_s"] = time.perf_counter() - t_start
    (out / "chip_smoke.json").write_text(json.dumps(record, indent=1, default=str))
    print(f"[{card}] total {record['total_s']:.1f} s")
    print(smi)                                   # name, power limit as nvidia-smi gives them
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    main()
