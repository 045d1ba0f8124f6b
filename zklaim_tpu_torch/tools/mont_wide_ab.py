"""K6 at the card's width: the launches tried for it, against the one K6
runs, on one card in one process.

csrc/mont_wide_variants.cu holds twelve launches of K6's work -- K chained
Montgomery squarings over Fq on (16, n) planes -- each another way to
overlap the next lanes' loads with this lane's products: K6's own launch
(flat), evict-first stores, two- and one-stage cp.async rings in shared
memory, 16-byte copies, register prefetch, two and four lanes a thread, and
prefetches into L2 of the lanes one wave ahead (its header says what each
does).  This tool builds that file on its own (it is not part of the kernel
library) and, at mont_micro.WIDE_LANES, times each of them and K6 itself
through its wrapper (mont_micro.mont_chain): device ms by graph replay
(utils/profiling.device_ms) at K = 2 and K = 0, and the product rate at
mont_micro.CHAIN = (64, 512), differenced as mont_micro.measure does.
Every launch is first held against mont_chain_plain at K = 2 on the card's
width and, where it takes any lane count, at K = 3 on the card's width + 77.
The list is timed --rounds times, forward and backward in turn, so that each
launch's spread and any drift of the card show.

    python -m zklaim_tpu_torch.tools.mont_wide_ab [--rounds 4] [--out FILE]

Prints the card, each variant's ptxas line and a table, and writes one JSON
record (default build/mont_wide_ab.json).  Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
from pathlib import Path

import torch

from .. import kernels as K
from ..kernels.cases import MADS_PER_PRODUCT
from ..utils.profiling import best_ms, card_label, device_ms
from . import mont_micro

SOURCE = K.CSRC / "mont_wide_variants.cu"
BUILD_DIR = K.BUILD_DIR.parent / "mont_wide_ab"
# the order of csrc/mont_wide_variants.cu's VARIANTS[]
VARIANTS = ("flat", "flat_stcs", "ring2", "ring1", "ring2_16", "regpf", "lanes2", "lanes4",
            "l2pf", "l2pf_stcs", "l2bulk", "l2bulk_stcs")
INFO = ("registers", "ctas_per_sm", "shared_bytes", "threads", "lanes_a_thread", "aligned")
SHIPPED = "K6 (probes.cu)"


def build() -> tuple:
    """(library path, ptxas lines): the variants' source compiled on its own
    with the kernel library's flags, once per source hash."""
    h = hashlib.sha256(" ".join(K.NVCC_FLAGS).encode())
    for path in [SOURCE] + [K.CSRC / name for name in K.HEADERS]:
        h.update(path.read_bytes())
    lib = BUILD_DIR / f"libmont_wide-{h.hexdigest()[:16]}.so"
    log = lib.with_suffix(".ptxas.txt")
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([K._nvcc(), *K.NVCC_FLAGS, "-shared", "-I", str(K.CSRC),
                               "-o", str(lib), str(SOURCE)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        log.write_text(proc.stderr)
    return lib, log.read_text()


class Variants:
    """The built variants: each one's info (registers, CTAs an SM holds, ...)
    and its launch, by index."""

    def __init__(self, path: Path):
        self.lib = ctypes.CDLL(str(path))
        self.lib.zk_mont_wide_info.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        self.lib.zk_mont_wide_launch.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
        self.infos = []               # read once: no CUDA query while a graph is captured
        for v, name in enumerate(VARIANTS):
            buf = (ctypes.c_int * len(INFO))()
            rc = self.lib.zk_mont_wide_info(v, buf)
            if rc:
                raise RuntimeError(f"zk_mont_wide_info({name}): CUDA error {rc}")
            self.infos.append(dict(zip(INFO, buf)))

    def launch(self, v: int, x: torch.Tensor, out: torch.Tensor, k: int, sms: int) -> torch.Tensor:
        """Variant v on (16, n) planes x into out: a persistent variant runs
        SMs x (CTAs an SM holds) CTAs, the others as many as cover the lanes;
        l2pf prefetches one such wave of lanes ahead."""
        info, n = self.infos[v], x.shape[1]
        wave = sms * info["ctas_per_sm"] * info["threads"]
        lanes = info["threads"] * info["lanes_a_thread"]
        grid = -(-n // lanes) if lanes else sms * info["ctas_per_sm"]
        rc = self.lib.zk_mont_wide_launch(v, x.data_ptr(), x.stride(0), out.data_ptr(),
                                          out.stride(0), n, k, grid, wave,
                                          torch.cuda.current_stream(x.device).cuda_stream)
        if rc:
            raise RuntimeError(f"{VARIANTS[v]}: CUDA error {rc}")
        return out


def measure(device, rounds: int) -> dict:
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError("mont_wide_ab needs a card")
    path, ptxas = build()
    lib, sms, n = Variants(path), K.sm_count(device), mont_micro.WIDE_LANES
    k1, k2 = mont_micro.CHAIN
    x = mont_micro.probe_input(n, device)
    ragged = mont_micro.probe_input(n + 77, device)
    outs = [torch.empty_like(x) for _ in VARIANTS]
    runs = {SHIPPED: lambda k: mont_micro.mont_chain(x, k)}
    for v, name in enumerate(VARIANTS):
        runs[name] = lambda k, v=v: lib.launch(v, x, outs[v], k, sms)

    want = mont_micro.mont_chain_plain(x, 2)
    want_ragged = mont_micro.mont_chain_plain(ragged, 3)
    rows = {}
    for name, run in runs.items():
        info = lib.infos[VARIANTS.index(name)] if name in VARIANTS else {}
        exact = torch.equal(run(2), want)
        if name == SHIPPED:
            exact &= torch.equal(mont_micro.mont_chain(ragged, 3), want_ragged)
        elif not info["aligned"]:
            v = VARIANTS.index(name)
            exact &= torch.equal(lib.launch(v, ragged, torch.empty_like(ragged), 3, sms),
                                 want_ragged)
        rows[name] = {**info, "exact": exact, "k2_ms": [], "k0_ms": [], "mads_per_s": []}
        if not exact:
            raise AssertionError(f"{name} differs from mont_chain_plain")
    names = list(runs)
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            run, row = runs[name], rows[name]
            row["k2_ms"].append(device_ms(lambda: run(2)))
            row["k0_ms"].append(device_ms(lambda: run(0)))
            t1, t2 = best_ms(lambda: run(k1), device), best_ms(lambda: run(k2), device)
            row["mads_per_s"].append(MADS_PER_PRODUCT * n * (k2 - k1) / ((t2 - t1) * 1e-3))
    return {"tool": "mont_wide_ab", "device": card_label(device), "lanes": n, "sms": sms,
            "chain": [k1, k2], "rounds": rounds, "ptxas": ptxas, "rows": rows}


def format_table(record: dict) -> str:
    lines = [f"[{record['device']}] K6 launches at {record['lanes']} lanes, {record['sms']} SMs, "
             f"{record['rounds']} rounds; device ms least / most of the rounds",
             f"{'launch':16} {'regs':>4} {'CTA/SM':>6} {'smem B':>6}  {'K=2 ms':>15}  "
             f"{'K=0 ms':>15}  T mads/s (K={record['chain'][0]}/{record['chain'][1]})"]
    for name, r in record["rows"].items():
        lines.append(f"{name:16} {r.get('registers', '-'):>4} {r.get('ctas_per_sm', '-'):>6} "
                     f"{r.get('shared_bytes', '-'):>6}  {min(r['k2_ms']):.4f} / {max(r['k2_ms']):.4f}"
                     f"  {min(r['k0_ms']):.4f} / {max(r['k0_ms']):.4f}  "
                     f"{min(r['mads_per_s']) / 1e12:.3f} / {max(r['mads_per_s']) / 1e12:.3f}")
    return "\n".join(lines)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--out", default=str(K.BUILD_DIR.parent / "mont_wide_ab.json"))
    args = ap.parse_args()
    record = measure(torch.device("cuda:0"), args.rounds)
    for line in record["ptxas"].splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            print(line.strip())
    print(format_table(record), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(record))
    print(json.dumps({k: v for k, v in record.items() if k != "ptxas"}))


if __name__ == "__main__":
    main()
