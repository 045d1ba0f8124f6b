"""One run of one cell: set-up, the measured window, the reference's check,
and the result line.

A cell (`workloads` in BENCHMARK.json) names a configuration and a traffic
mix.  Everything that belongs to one of them is found by its name:

- configs/<file named in BENCHMARK.json>: sizes, guarantees, and the name
  of the plain reference (reference/<reference>.py) that judges the run;
- traffic/<traffic>.json: the mix's parameters, read by generator.py, with
  its loop shape (`loop`: loops/<loop>.py) and the steps of one request
  (`steps`: steps/<step>.py each, run in order);
- metrics/<name>.py: the reader of a per-layer metric, `read(record)`,
  which returns the metric's value or None where it finds nothing to read.

A step is `run(roles, rec)`: it drives the program through `roles` and
writes what it returns into the request's record `rec` (statuses, proof,
wire bytes); the harness times each step into rec["times"][step].  A loop
is `window(request, seconds, params)`: it serves requests until the window
closes and returns their records.

The roles run as zklaim's users run them, through the program's public
entries (`claims.api.Context`, `claims.signing`, `kernels`).  Set-up: the
issuer signs a pool of credentials and runs the trusted setup once; the
holder's context imports the pk with its first proof; a few requests warm
up.  Each request takes the next credential of the pool.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import random
import time
from pathlib import Path

import torch

from . import correct, tracing
from .generator import Traffic

FOLDER = Path(__file__).resolve().parent.name        # the benchmark's folder, under the root
OK = 0


def load_module(path: Path):
    """A module of the benchmark's own by its file (a name may hold dots)."""
    name = "zkbench_" + "_".join(path.parts[-2:]).replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(root: Path, name: str):
    """The reader of per-layer metric `name`."""
    return load_module(root / FOLDER / "metrics" / f"{name}.py")


def load_cell(bench: dict, name: str, root: Path) -> dict:
    """The cell `name` of BENCHMARK.json (read from `root`) with its
    configuration, traffic parameters, reference and metrics, each found by
    its name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((root / entry["file"]).read_text())
    mix = json.loads((root / FOLDER / "traffic" / f"{cell['traffic']}.json").read_text())

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return {"cell": cell, "config": config, "traffic": mix, "root": root,
            "reference": importlib.import_module(f"zkbench.reference.{config['reference']}"),
            "loop": load_module(root / FOLDER / "loops" / f"{mix['loop']}.py"),
            "steps": {step: load_module(root / FOLDER / "steps" / f"{step}.py")
                      for step in mix["steps"]},
            "end_to_end": mine(bench["end_to_end"]), "per_layer": mine(bench["per_layer"])}


def percentile(values: list, q: float) -> float:
    """The q-th percentile, linear between the two nearest ranks."""
    v = sorted(values)
    pos = (len(v) - 1) * q / 100
    i = int(pos)
    return v[i] if i + 1 >= len(v) else v[i] + (v[i + 1] - v[i]) * (pos - i)


def end_to_end(name: str, run: dict) -> float:
    """An end-to-end metric by its name: proofs_per_s, setup_s,
    trusted_setup_s, or <step>_ms_p<q>, the q-th percentile of a step's
    time over every request of the window."""
    if name == "proofs_per_s":
        return run["completed"] / run["window_s"]
    if name in ("setup_s", "trusted_setup_s"):
        return run[name]
    step, _, q = name.partition("_ms_p")
    return percentile([r["times"][step] * 1e3 for r in run["requests"]], float(q))


class Roles:
    """The issuer's pool and keys, the holder's context, and one request."""

    def __init__(self, spec: dict, seed: int, device):
        from zklaim_tpu_torch.claims import signing
        from zklaim_tpu_torch.claims.api import Context, Payload

        self.Context, self.Payload = Context, Payload
        self.device = device
        n_pl = spec["config"]["num_payloads"]
        self.gen = Traffic(spec["traffic"], n_pl, seed)
        self.setup_seed = f"zkbench/{seed}/setup"

        rng = self.gen.rng("issuer")
        priv = signing.keygen(rng)
        self.pool = []
        for j in range(spec["traffic"]["pool"]):
            attrs = self.gen.credential(j)
            ctx = Context(device)
            for values in attrs:
                pl = Payload()
                for pos, a in enumerate(values):
                    pl.set_attr(a, pos)
                ctx.add_payload(pl)
            ctx.hash_payloads(rng)
            if j == 0:
                t0 = time.perf_counter()
                if ctx.trusted_setup(random.Random(self.setup_seed)) != OK:
                    raise RuntimeError("trusted_setup failed")
                self.sync()
                self.trusted_setup_s = time.perf_counter() - t0
                self.issuer = {"pk": ctx.pk, "vk": ctx.vk, "pub_key": signing.pk_to_pub(priv)}
            ctx.vk = self.issuer["vk"]
            ctx.sign(priv, rng)
            self.pool.append({"attrs": attrs, "pre": [p.pre for p in ctx.payloads],
                              "salt": [p.salt for p in ctx.payloads],
                              "hash": [p.hash for p in ctx.payloads],
                              "signature": ctx.signature})
        self.spans = None                           # (start, end, name) ns, while traced
        self.holder = Context(device)
        self.holder.pk, self.holder.vk = self.issuer["pk"], self.issuer["vk"]
        self.holder.pub_key = self.issuer["pub_key"]

    @contextlib.contextmanager
    def span(self, name: str):
        """A span of the host on the clock the profiler's events use."""
        if self.spans is None:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((t0, time.time_ns(), name))

    def sync(self):
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)

    def request(self, steps: dict, stream: str, i: int) -> dict:
        """Request i of a stream ("warmup" or "window"): its record, the
        steps run in order, each timed."""
        rec = {"stream": stream, "index": i, "credential": i % len(self.pool),
               "statuses": {}, "times": {}}
        t0 = time.perf_counter()
        for name, step in steps.items():
            t = time.perf_counter()
            step.run(self, rec)
            rec["times"][name] = time.perf_counter() - t
        rec["times"]["request"] = time.perf_counter() - t0
        return rec


def inject(fault: str, roles: Roles) -> None:
    """Break the timed path underneath the harness, for the control runs
    and the tests: `stale_proof` makes `proof_generate` return ZKLAIM_OK
    and leave the previous proof in place; `altered_proof` replaces the C
    point of each proof it returns by C + G."""
    from .reference.bn254.hostcurve import g1_generator
    from .reference.credential import parse_g1

    holder = roles.holder
    prove = holder.proof_generate

    def stale_proof(rng=None):
        return OK

    def altered_proof(rng=None):
        status = prove(rng)
        c = parse_g1(holder.proof[196:260]) + g1_generator()
        holder.proof = holder.proof[:196] + c.x.v.to_bytes(32, "big") + c.y.v.to_bytes(32, "big")
        return status

    holder.proof_generate = {"stale_proof": stale_proof, "altered_proof": altered_proof}[fault]


def run(spec: dict, seed: int, seconds: float, trace: bool, device, t_process: float,
        fault: str | None = None, log=print) -> dict:
    """One run; returns the result line as a dict (checks last)."""
    from zklaim_tpu_torch import kernels

    cuda = torch.device(device).type == "cuda"
    if cuda:
        kernels.library()
    t0 = time.perf_counter()
    roles = Roles(spec, seed, device)
    t1 = time.perf_counter()
    steps = spec["steps"]
    warm = [roles.request(steps, "warmup", i)["times"]["request"]
            for i in range(spec["traffic"]["warmup_requests"])]
    log(f"set-up s: process to roles {t0 - t_process:.3f}, issuer and pool {t1 - t0:.3f} "
        f"(trusted_setup {roles.trusted_setup_s:.3f}), warm-up requests "
        + ", ".join(f"{w:.3f}" for w in warm))
    if fault:
        inject(fault, roles)
    launches0 = dict(kernels.LAUNCHES)

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU])
        prof.__enter__()
        roles.spans = []
    roles.sync()
    t_start, ns_start = time.perf_counter(), time.time_ns()
    requests = spec["loop"].window(lambda i: roles.request(steps, "window", i), seconds,
                                   spec["traffic"])
    t_end, ns_end = time.perf_counter(), time.time_ns()
    if prof is not None:
        prof.__exit__(None, None, None)

    completed = sum(all(s == OK for s in r["statuses"].values()) for r in requests)
    for step in requests[0]["times"]:
        log(f"{step} ms: " + " ".join(f"{r['times'][step] * 1e3:.1f}" for r in requests))
    run = {"requests": requests, "completed": completed, "window_s": t_end - t_start,
           "setup_s": t_start - t_process, "trusted_setup_s": roles.trusted_setup_s}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": 1,
                   "memory_peak_bytes": torch.cuda.max_memory_allocated(device) if cuda else 0}
    launches = {k: (v - launches0[k]) / len(requests)
                for k, v in kernels.LAUNCHES.items() if v != launches0[k]}
    print("launches_per_request " + json.dumps(launches), flush=True)

    extra = {}
    if trace:
        t0 = time.perf_counter()
        rec = tracing.record(prof.profiler.kineto_results.events(), (ns_start, ns_end),
                             roles.spans, completed)
        del prof
        log(f"trace read in {time.perf_counter() - t0:.1f} s: {rec['events']} events on the "
            f"card, {rec['kernel_count']} kernels in the window; the card's activity starts "
            f"and ends inside the window by {rec['edges_s']} s")
        metrics = {}
        for m in spec["per_layer"]:
            value = reader(spec["root"], m["name"]).read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=rec["busy_s"], window_s=rec["window_s"])
        extra["breakdown"] = tracing.breakdown(rec)
    else:
        metrics = {m["name"]: {"value": end_to_end(m["name"], run), "unit": m["unit"]}
                   for m in spec["end_to_end"]}

    issuer, pool, setup_seed = roles.issuer, roles.pool, roles.setup_seed
    del roles
    if cuda:
        torch.cuda.empty_cache()
    checked = correct.sample(len(requests), spec["traffic"]["check_sample"], seed)
    numbers = correct.compare(spec["reference"], spec["config"], setup_seed,
                              issuer, pool, requests, checked, log)
    return {"correct": correct.verdict(numbers), "attempted": len(requests),
            "failed": len(requests) - completed, "metrics": metrics, "device": device_info,
            **extra, "checks": correct.report(numbers)}
