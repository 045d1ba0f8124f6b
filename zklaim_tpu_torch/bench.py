"""Benchmark entry point of the port: prints ONE JSON line.

    python -m zklaim_tpu_torch.bench [--full | --all] [--log2n N] [--out F] [--device cpu]

Counterpart of bench.py at the repository's root, with the same metric
names and units, the same seeds, and on every row "impl": "torch" plus the
device the row was taken on (`card_label`: the card's name and power limit).

Headline metric: G1 Pippenger MSM throughput (points/s) at 2^16 points --
the primitive that dominates Groth16 setup/prove cost.  The default run
prints the headline; `--full` runs the end-to-end credential flow and
reports the warm prover latency instead; `--all` runs the whole surface
(G1/G2 MSM and Fr NTT at 2^16 / 2^20 / 2^22, warm prover latency and
proofs/s, batched proving) and writes every row to --out (default
build/bench_all.json) while printing the headline line.  vs_baseline is
1.0: the reference publishes no numbers.

Every sample is a warm in-process repeat that ends in a synchronise of the
device; a row is the least of `runs` samples.  The default device is the
card (it raises without one); `--device cpu` drives the plain versions,
and its rows say "cpu": they are no device metric.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import time

import numpy as np
import torch

from . import resolve_device
from .utils.profiling import card_label, sync

DEFAULT_OUT = os.path.join("build", "bench_all.json")


def _row(device, metric: str, value, unit: str) -> dict:
    row = {"metric": metric, "value": value, "unit": unit, "vs_baseline": 1.0,
           "impl": "torch", "device": card_label(device)}
    if torch.device(device).type == "cuda":
        row["peak_mem_bytes"] = torch.cuda.max_memory_allocated(device)
    return row


def _reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.init()                 # a fresh process has no CUDA context yet
        torch.cuda.reset_peak_memory_stats(device)


def _best_s(fn, device, runs: int) -> float:
    """Least seconds of `runs` calls, each ended by a synchronise, after one
    warm-up call."""
    fn()
    sync(device)
    best = float("inf")
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


def make_points(deg: int, n: int, device) -> torch.Tensor:
    """n device points as packed rows (n, 48 deg): a 2^14 batch of distinct
    multiples of G, tiled.

    Tiling repeats points past 2^14 -- harmless for a throughput benchmark
    (the scalars stay random) -- and keeps the set-up to one 2^14-lane
    ladder whatever n is."""
    from .ec import curve as C
    from .ec.gpu_curve import scalar_mul
    from .ec.hostcurve import g1_generator, g2_generator
    from .ff.limbs import to_tensor

    base = min(n, 1 << 14)
    f = C.ops_for(deg)
    gen = g1_generator() if deg == 1 else g2_generator()
    gen_planes = C.point_to_planes(f, C.host_points_to_proj(f, [gen], device))
    small = np.zeros((base, 16), dtype=np.int32)
    k = np.arange(1, base + 1, dtype=np.int64)
    small[:, 0], small[:, 1] = k & 0xFFFF, k >> 16
    pts = scalar_mul(deg, gen_planes.expand(-1, -1, base).contiguous(), to_tensor(small, device))
    return C.planes_to_rows(pts).repeat(n // base, 1)


def bench_msm(log2n: int = 16, c: int = 8, runs: int = 3, kind: str = "g1", device=None):
    from .ff.limbs import ints_to_limbs, to_tensor
    from .ff.params import R
    from .msm.pippenger import msm_pow2

    device = resolve_device(device)
    deg = 1 if kind == "g1" else 2
    n = 1 << log2n
    rows = make_points(deg, n, device)
    prng = random.Random(20260817)
    scalars = to_tensor(ints_to_limbs([prng.randrange(R) for _ in range(n)]), device)

    _reset_peak(device)
    best = _best_s(lambda: msm_pow2(deg, rows, scalars, c), device, runs)
    return _row(device, f"{kind}_msm_2^{log2n}_points_per_sec", round(n / best, 1), "points/s")


def bench_ntt(log2n: int = 16, runs: int = 3, device=None):
    from .ff import montgomery as M
    from .ff.limbs import to_tensor
    from .ff.montgomery import FR
    from .ff.params import R
    from .ntt.radix2 import get_domain

    device = resolve_device(device)
    n = 1 << log2n
    _reset_peak(device)
    dom = get_domain(n, str(device))
    prng = random.Random(20260818)
    coeffs = to_tensor(M.encode_ints(FR, [prng.randrange(R) for _ in range(n)]), device)

    best = _best_s(lambda: dom.ntt(coeffs), device, runs)
    return _row(device, f"ntt_fr_2^{log2n}_elems_per_sec", round(n / best, 1), "elems/s")


def demo_context(rng, device, num_payloads: int = 1):
    """The demo credential: payloads with attribute 23 held to >= 18."""
    from .claims.api import Context, Payload, ZkOp

    ctx = Context(device)
    for _ in range(num_payloads):
        pl = Payload()
        pl.set_attr(23, 0)
        pl.data_ref = [18, 0, 0, 0, 0]
        pl.data_op = [ZkOp.GREATER_OR_EQ] + [ZkOp.NOOP] * 4
        ctx.add_payload(pl)
    ctx.hash_payloads(rng)
    return ctx


def bench_prover(runs: int = 3, device=None):
    from .claims import signing
    from .claims.api import ZKLAIM_OK

    device = resolve_device(device)
    rng = random.Random(1)
    ctx = demo_context(rng, device)
    _reset_peak(device)
    t0 = time.perf_counter()
    assert ctx.trusted_setup(rng) == ZKLAIM_OK
    sync(device)
    issuer_cold_s = time.perf_counter() - t0
    # the first call of a process builds the kernels and the fixed-base comb
    # tables; every later issuer call runs warm
    t0 = time.perf_counter()
    assert ctx.trusted_setup(rng) == ZKLAIM_OK
    sync(device)
    issuer_s = time.perf_counter() - t0
    ctx.sign(signing.keygen(rng), rng)

    def generate():
        assert ctx.proof_generate(rng) == ZKLAIM_OK

    best = _best_s(generate, device, runs)
    ctx.clear_pres()
    t0 = time.perf_counter()
    assert ctx.verify() == ZKLAIM_OK
    verifier_s = time.perf_counter() - t0
    return [
        _row(device, "groth16_prover_latency_1payload", round(best * 1e3, 1), "ms"),
        _row(device, "groth16_proofs_per_sec_1payload", round(1.0 / best, 3), "proofs/s"),
        _row(device, "issuer_trusted_setup_1payload", round(issuer_s * 1e3, 1), "ms"),
        _row(device, "issuer_trusted_setup_1payload_cold", round(issuer_cold_s * 1e3, 1), "ms"),
        _row(device, "verifier_latency_1payload", round(verifier_s * 1e3, 1), "ms"),
        _row(device, "proof_size", len(ctx.proof), "B"),
        _row(device, "pk_size", len(ctx.pk), "B"),
        _row(device, "vk_size", len(ctx.vk), "B"),
    ]


def bench_batched(batch: int = 8, runs: int = 3, device=None):
    """Batched proving throughput on the credential circuit on a mesh of
    one device: `batch` proofs of one circuit against one uploaded proving
    key."""
    from .claims.circuit import ZKlaimCircuit
    from .groth16.api import setup, verify
    from .parallel.mesh import make_mesh
    from .parallel.prove import batched_prove

    device = resolve_device(device)
    rng = random.Random(7)
    ctx = demo_context(rng, device)
    circ = ZKlaimCircuit(1)
    pk, vk, qap = setup(circ.cs, rng, device)
    inputs = [(p.pre, p.data_ref, p.op_positions()) for p in ctx.payloads]
    witnesses = [circ.witness(inputs)] * batch
    mesh = make_mesh(1, device=device)
    _reset_peak(device)
    last = {}

    def run():
        last["proofs"] = batched_prove(mesh, pk, qap, witnesses, rng)

    best = _best_s(run, device, runs)
    assert verify(vk, circ.public_inputs(inputs), last["proofs"][0])
    return _row(device, f"groth16_proofs_per_sec_batch{batch}", round(batch / best, 3),
                "proofs/s")


def bench_all(out_path: str = DEFAULT_OUT, device=None, sizes=(16, 20, 22)):
    from .ntt.radix2 import get_domain

    device = resolve_device(device)
    rows = []

    def push(row):
        rows.append(row)
        print(json.dumps(row), file=sys.stderr, flush=True)

    for kind in ("g1", "g2"):
        for log2n in sizes:
            push(bench_msm(log2n, kind=kind, device=device))
    for log2n in sizes:
        push(bench_ntt(log2n, device=device))
    # the cached domains hold 1.3 GB of twiddles at 2^20 and 2^22: free them,
    # so that the peak memory of the rows below is their own
    get_domain.cache_clear()
    for row in bench_prover(device=device):
        push(row)
    push(bench_batched(device=device))
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as fh:
        json.dump(rows, fh, indent=1)
    return next(r for r in rows if r["metric"] == f"g1_msm_2^{sizes[0]}_points_per_sec")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="zklaim_tpu_torch.bench")
    ap.add_argument("--full", action="store_true", help="end-to-end prover latency")
    ap.add_argument("--all", action="store_true", help="the whole surface -> --out")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--log2n", type=int, default=16)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.all:
        result = bench_all(args.out, device)
    elif args.full:
        result = bench_prover(device=device)[0]
    else:
        result = bench_msm(args.log2n, device=device)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
