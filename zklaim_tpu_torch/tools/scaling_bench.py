"""Scaling of the multi-device path: points/s per rank and the four-step
NTT's round trip at S = 1, 2, 4, 8 ranks, up to the world's size.

Counterpart of tools/scaling_bench.py on torch.distributed.  For each S
the mesh is the first S ranks (parallel.mesh.make_mesh(S)); each of them
runs parallel.msm.sharded_msm of 2^log2n G1 points (n/S a rank, c = 8) and
the distributed transform of ShardedNTT(mesh, 2^log2n) on its block,
intt_t_shard(ntt_t_shard(x)) -- what the JAX package's sharded round trip
costs, without the gathers of the global ntt_t / intt_t; the ranks past S
wait.  Each time is the least of `repeats` runs on the host clock (the
first warms up), between synchronises of the rank's device, on rank 0.  The
table goes
to build/scaling_bench.{json,md} (never SCALING.md, the JAX package's
record), written by rank 0.

One process is a world of one: S = 1 only.  Several ranks -- one a card,
NCCL; or CPU processes, gloo -- are started by torchrun (the env:// variables)
or by ZKLAIM_COORDINATOR / ZKLAIM_NUM_PROCESSES / ZKLAIM_PROCESS_ID, which
parallel.mesh.init_distributed reads:

    python -m zklaim_tpu_torch.tools.scaling_bench [--log2n 13] [--device cpu]
    torchrun --nproc-per-node 4 -m zklaim_tpu_torch.tools.scaling_bench
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

from .. import resolve_device
from ..utils.profiling import sync

OUT = Path(__file__).resolve().parents[2] / "build" / "scaling_bench"
SHARDS = (1, 2, 4, 8)
SEED = 20260820


def _timed(fn, device, repeats: int) -> float:
    best = float("inf")
    for _ in range(repeats):
        sync(device)
        t0 = time.perf_counter()
        fn()
        sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


def measure(device=None, log2n: int = 13, repeats: int = 3) -> dict:
    """{"msm": rows, "ntt": rows} for each S up to the world's size.  Every
    rank of the world calls it; rank 0's rows are the table."""
    import torch.distributed as dist

    from ..entry import multiple_rows, random_scalars
    from ..ff import montgomery as M
    from ..parallel import mesh as MESH
    from ..parallel.msm import sharded_msm
    from ..parallel.ntt import ShardedNTT

    distributed = MESH.init_distributed(device=device)
    rank, world = MESH.world()
    device = MESH.rank_device() if distributed else resolve_device(device)
    n = 1 << log2n
    nrng = np.random.default_rng(SEED)
    rows, _ = multiple_rows(n, device)
    scalars = random_scalars(n, nrng, device)
    coeffs = M.to_mont(M.FR, random_scalars(n, nrng, device))
    out = {"world": world, "log2n": log2n, "device": str(device), "msm": [], "ntt": []}
    ref = None
    for shards in SHARDS:
        if shards > world:
            break
        mesh = MESH.make_mesh(shards, device=device)
        if mesh.coords is not None:
            dt = _timed(lambda: sharded_msm(mesh, 1, rows, scalars), device, repeats)
            pts = n / dt
            ref = ref or pts
            out["msm"].append({"shards": shards, "points_per_rank": n // shards, "wall_s": dt,
                               "points_per_s": pts, "points_per_s_per_rank": pts / shards,
                               "efficiency_vs_1": pts / (ref * shards)})
            plan = ShardedNTT(mesh, n)
            i = plan.index
            x = plan.to_matrix(coeffs)[:, i * plan.cols : (i + 1) * plan.cols].contiguous()
            dt = _timed(lambda: plan.intt_t_shard(plan.ntt_t_shard(x)), device, repeats)
            out["ntt"].append({"shards": shards, "ntt_roundtrip_wall_s": dt})
        if distributed:
            dist.barrier()
    out["rank"] = rank
    return out


def format_table(res: dict) -> str:
    lines = [f"# Scaling of the multi-device path (world of {res['world']}, {res['device']}, "
             f"N = 2^{res['log2n']})", "", "## sharded MSM (G1, c = 8)", "",
             "| shards | points/rank | wall s | points/s | points/s/rank | eff vs 1 |",
             "|---|---|---|---|---|---|"]
    for r in res["msm"]:
        lines.append(f"| {r['shards']} | {r['points_per_rank']} | {r['wall_s']} | "
                     f"{r['points_per_s']} | {r['points_per_s_per_rank']} | "
                     f"{r['efficiency_vs_1']} |")
    lines += ["", "## four-step NTT round trip (a rank's block)", "", "| shards | wall s |",
              "|---|---|"]
    lines += [f"| {r['shards']} | {r['ntt_roundtrip_wall_s']} |" for r in res["ntt"]]
    return "\n".join(lines) + "\n"


def write(res: dict, out: Path = OUT) -> list:
    """Rank 0 writes <out>.json and <out>.md; returns the paths written."""
    if res["rank"] != 0:
        return []
    out.parent.mkdir(parents=True, exist_ok=True)
    paths = [out.with_suffix(".json"), out.with_suffix(".md")]
    paths[0].write_text(json.dumps(res, indent=1))
    paths[1].write_text(format_table(res))
    return paths


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log2n", type=int, default=13)
    ap.add_argument("--device", default=None, help="default: the card (cuda)")
    ap.add_argument("--out", default=str(OUT), help="path without suffix (default %(default)s)")
    args = ap.parse_args(argv)
    from ..parallel.mesh import shutdown_distributed

    res = measure(args.device, args.log2n)
    for r in res["msm"] + res["ntt"]:
        print(json.dumps(r), flush=True)
    for path in write(res, Path(args.out)):
        print(f"wrote {path}")
    shutdown_distributed()


if __name__ == "__main__":
    main()
