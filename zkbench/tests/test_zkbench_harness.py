"""The harness on the CPU: BENCHMARK.json against the contract's rules,
discovery of configurations, traffic mixes and metric readers by name
(and adding one of each without editing a file), the result line of a run
of a tiny configuration, and the checks that keep JAX out and refuse to run
without a card.

Run from the root of the repository:
    python -m pytest zkbench/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import hashlib
import json
import re
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from zkbench import harness, run, tracing

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}$")
TINY = {"name": "tiny-n0", "source": "the zero-payload context of zklaim's API",
        "reduced": [], "num_payloads": 0, "reference": "credential",
        "sizes": {"constraints": 0, "variables": 1, "primary": 0, "m": 1,
                  "pk_bytes": 724, "vk_bytes": 520, "proof_bytes": 260}}


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["zkbench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("zkbench/") and c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] == []
        assert (ROOT / "zkbench" / "reference" / f"{cfg['reference']}.py").exists()
    cells = {w["name"]: w for w in BENCH["workloads"]}
    for w in cells.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200 and NAME.match(w["traffic"])
        mix = json.loads((ROOT / "zkbench" / "traffic" / f"{w['traffic']}.json").read_text())
        assert (ROOT / "zkbench" / "loops" / f"{mix['loop']}.py").exists()
        assert all((ROOT / "zkbench" / "steps" / f"{s}.py").exists() for s in mix["steps"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert harness.reader(ROOT, m["name"]).read
        assert m["layer"] in ("device", "kernels")
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", cells)
    for cell in cells:
        assert any(cell in m.get("workloads", cells) for m in BENCH["per_layer"])
        assert len([m for m in BENCH["end_to_end"] if cell in m.get("workloads", cells)]) >= 2


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cells_are_found_by_name(cell):
    spec = harness.load_cell(BENCH, cell, ROOT)
    assert spec["config"]["name"] == spec["cell"]["config"]
    assert list(spec["steps"])[:2] == ["claim", "prove"]
    assert all(callable(step.run) for step in spec["steps"].values())
    assert callable(spec["loop"].window)
    assert spec["reference"].__name__ == "zkbench.reference.credential"
    assert {m["name"] for m in spec["per_layer"]} == {
        "device_idle_pct", "kernel_launches_per_proof"}
    moved = {m["moves"] for m in spec["per_layer"]}
    assert moved <= {m["name"] for m in spec["end_to_end"]}


def _digests(folder: Path) -> dict:
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in folder.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


# a step the harness has never seen: a fresh holder context imports the pk
# and proves the claim, as a holder's new process would
FRESH_HOLDER = """
def run(roles, rec):
    holder = roles.Context(roles.device)
    holder.pk, holder.vk = roles.issuer["pk"], roles.issuer["vk"]
    holder.pub_key = roles.issuer["pub_key"]
    holder.payloads, holder.signature = roles.holder.payloads, roles.holder.signature
    with roles.span("proof_generate"):
        rec["statuses"]["fresh_holder"] = holder.proof_generate(
            roles.gen.rng(rec["stream"] + ".fresh", rec["index"]))
        roles.sync()
    rec["proof"] = holder.proof
"""
# a loop shape the harness has never seen: a fixed number of requests
FIXED_COUNT = """
def window(request, seconds, params):
    return [request(i) for i in range(params["requests"])]
"""


def test_a_config_a_mix_and_a_metric_are_added_as_files(tmp_path, capsys):
    """A new configuration, traffic mix (with a step and a loop shape of its
    own) and end-to-end and per-layer metrics: new files and new
    BENCHMARK.json entries, no file that was there changes, and a run of
    the new cell reports the new metric and is correct."""
    folder = tmp_path / "zkbench"
    shutil.copytree(ROOT / "zkbench", folder, ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(folder)
    (folder / "configs" / "tiny-n0.json").write_text(json.dumps(TINY))
    mix = json.loads((ROOT / "zkbench" / "traffic" / "prove.json").read_text())
    (folder / "traffic" / "fresh_holder.json").write_text(json.dumps(
        {**mix, "loop": "fixed_count", "requests": 1, "pool": 2, "warmup_requests": 0,
         "steps": ["claim", "fresh_holder"]}))
    (folder / "steps" / "fresh_holder.py").write_text(FRESH_HOLDER)
    (folder / "loops" / "fixed_count.py").write_text(FIXED_COUNT)
    (folder / "metrics" / "busy_ms.per_proof.py").write_text(
        "def read(rec):\n    return 1e3 * rec['busy_s'] / rec['requests'] or None\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "tiny-n0", "source": TINY["source"],
                             "file": "zkbench/configs/tiny-n0.json", "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "n0.fresh", "config": "tiny-n0",
                               "traffic": "fresh_holder", "chips": 1, "why": "x"})
    bench["end_to_end"].append({"name": "fresh_holder_ms_p50", "unit": "ms", "better": "lower",
                                "bound": 0.1, "source": "host_clock",
                                "workloads": ["n0.fresh"]})
    bench["per_layer"].append({"name": "busy_ms.per_proof", "unit": "ms", "better": "lower",
                               "source": "device_trace", "layer": "device",
                               "moves": "fresh_holder_ms_p50", "workloads": ["n0.fresh"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = harness.load_cell(bench, "n0.fresh", tmp_path)
    assert spec["config"]["num_payloads"] == 0 and list(spec["steps"]) == ["claim",
                                                                        "fresh_holder"]
    assert [m["name"] for m in spec["per_layer"]] == ["busy_ms.per_proof"]
    assert harness.reader(tmp_path, "busy_ms.per_proof").read(
        {"busy_s": 0.5, "requests": 2}) == 250.0
    args = ["--workload", "n0.fresh", "--seed", str(2**31 + 9), "--seconds", "60",
            "--bench", str(tmp_path / "BENCHMARK.json")]
    assert run.main(args, device="cpu") == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True and line["attempted"] == 1
    assert line["metrics"]["fresh_holder_ms_p50"]["value"] > 0
    assert line["checks"]["proofs_checked"]["value"] == 1
    assert all(_digests(folder)[p] == d for p, d in before.items())


def test_readers_leave_out_what_they_cannot_read():
    for name in ("device_idle_pct", "kernel_launches_per_proof"):
        reader = harness.load_module(ROOT / "zkbench" / "metrics" / f"{name}.py")
        assert reader.read({"kernel_count": 0, "window_s": 1.0, "busy_s": 0.0,
                            "requests": 3}) is None
    rec = {"kernel_count": 30, "window_s": 2.0, "busy_s": 0.5, "requests": 3}
    assert harness.load_module(ROOT / "zkbench" / "metrics" / "device_idle_pct.py").read(rec) == 75
    assert harness.load_module(
        ROOT / "zkbench" / "metrics" / "kernel_launches_per_proof.py").read(rec) == 10


class _Event:
    """A profiler event: on the card or on the host, a name, a time span."""

    def __init__(self, kind, name, start, end):
        self.kind, self.n, self.s, self.e = kind, name, start, end

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CPU if self.kind == "host" else DeviceType.CUDA

    def name(self):
        return self.n

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.e - self.s


def test_trace_record_busy_idle_and_gaps():
    events = [_Event("card", "k1", 100, 300), _Event("card", "k1", 250, 400),
              _Event("card", "Memcpy HtoD", 500, 550), _Event("card", "k2", 1100, 1200),
              _Event("host", "cudaLaunchKernel", 10, 20)]
    spans = [(600, 1000, "verify"), (0, 600, "proof_generate")]
    rec = tracing.record(events, (0, 1000), spans, requests=2)
    assert rec["kernel_count"] == 2 and rec["window_s"] == 1e-6 and rec["events"] == 4
    assert rec["busy_s"] == pytest.approx(350e-9)
    assert rec["idle_s_by_span"] == pytest.approx({"proof_generate": 250e-9,
                                                   "verify": 400e-9, "harness": 0})
    assert rec["edges_s"] == pytest.approx((100e-9, -200e-9))
    bd = tracing.breakdown(rec)
    assert bd["device_ops"] == [["k1", pytest.approx(350e-9)]]
    assert bd["idle_gaps"][0][0] == "verify"
    assert tracing.record(events, (0, 1000), [(0, 50, "claim")], 1)["idle_s_by_span"] == (
        pytest.approx({"claim": 50e-9, "harness": 600e-9}))


def test_forbidden_modules_compare_whole_top_level_names():
    assert run.forbidden_modules(["zklaim_tpu_torch", "zklaim_tpu_torch.claims.api",
                                  "jaxtyping", "flaxen", "numpy"]) == []
    assert run.forbidden_modules(["zklaim_tpu.ff.params", "jax._src.core", "jaxlib",
                                  "flax.linen", "zklaim_tpu_torch"]) == [
        "flax", "jax", "jaxlib", "zklaim_tpu"]


def test_no_result_where_the_jax_package_is_loaded(monkeypatch, capsys):
    monkeypatch.setattr(harness, "run", lambda *a, **k: {"correct": True, "checks": {}})
    monkeypatch.setitem(sys.modules, "zklaim_tpu", types.ModuleType("zklaim_tpu"))
    args = ["--workload", "n1.present", "--seed", "1", "--seconds", "1"]
    assert run.main(args, device="cpu") == 3
    assert capsys.readouterr().out == ""


def test_no_result_without_a_card_or_without_the_program(tmp_path):
    """Without CUDA, and in a directory that holds only the benchmark's
    files, the command exits with another code than 0 and prints nothing."""
    args = ["--workload", "n1.present", "--seed", str(2**31 + 11), "--seconds", "1",
            "--trace", "0"]
    shutil.copytree(ROOT / "zkbench", tmp_path / "zkbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for cwd in (ROOT, tmp_path):
        out = subprocess.run([sys.executable, "zkbench/run.py", *args], cwd=cwd,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0 and out.stdout == ""


def _tiny_bench(tmp_path: Path, traffic: str) -> Path:
    (tmp_path / "tiny-n0.json").write_text(json.dumps(TINY))
    mix = json.loads((ROOT / "zkbench" / "traffic" / f"{traffic}.json").read_text())
    folder = tmp_path / "zkbench"
    shutil.copytree(ROOT / "zkbench", folder, ignore=shutil.ignore_patterns("__pycache__"))
    (folder / "traffic" / "tiny.json").write_text(json.dumps(
        {**mix, "pool": 2, "warmup_requests": 1}))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"] = [{"name": "tiny-n0", "source": TINY["source"],
                         "file": str(tmp_path / "tiny-n0.json"), "reduced": [], "why": "x"}]
    bench["workloads"] = [{"name": "tiny", "config": "tiny-n0", "traffic": "tiny",
                           "chips": 1, "why": "x"}]
    mixes = {w["name"]: w["traffic"] for w in BENCH["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:                        # the metrics of the cells of this mix
            m["workloads"] = ["tiny"] if traffic in {mixes[w] for w in m["workloads"]} else []
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path / "BENCHMARK.json"


def run_tiny(tmp_path, capsys, traffic="present", trace=0, fault=None):
    """A run of the zero-payload configuration on the CPU through run.main:
    (exit code, the result line, standard error)."""
    args = ["--workload", "tiny", "--seed", str(2**31 + 5), "--seconds", "0.5",
            "--trace", str(trace), "--bench", str(_tiny_bench(tmp_path, traffic))]
    rc = run.main(args + (["--fault", fault] if fault else []), device="cpu")
    out = capsys.readouterr()
    return rc, json.loads(out.out.strip().splitlines()[-1]), out.err


def test_result_line_of_a_tiny_run(tmp_path, capsys):
    rc, line, err = run_tiny(tmp_path, capsys)
    assert rc == 0 and line["correct"] is True
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {m["name"] for m in BENCH["end_to_end"]
                                    if "n1.present" in m.get("workloads", ["n1.present"])}
    assert set(line["metrics"]) == {"proofs_per_s", "prove_ms_p95", "verify_ms_p95", "setup_s"}
    for name, m in line["metrics"].items():
        assert m["value"] > 0 and m["unit"] == next(
            e["unit"] for e in BENCH["end_to_end"] if e["name"] == name)
    assert line["device"] == {"platform": "cpu", "kind": "cpu", "count": 1,
                              "memory_peak_bytes": 0}
    tail = err.strip().splitlines()[-len(line["checks"]) - 1:]
    assert [t.split()[1] for t in tail[:-1]] == list(line["checks"])
    assert tail[-1] == "correct = true"


def test_result_line_of_a_tiny_traced_run(tmp_path, capsys):
    """On the CPU the trace holds no device activity: the readers find
    nothing, and their metrics are left out of the line."""
    rc, line, _ = run_tiny(tmp_path, capsys, traffic="prove", trace=1)
    assert rc == 0 and line["correct"] is True and line["metrics"] == {}
    assert list(line)[-2:] == ["breakdown", "checks"]
    assert line["device"]["busy_s"] == 0 and line["device"]["window_s"] > 0
    assert line["breakdown"]["device_ops"] == []


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_a_cell_on_the_card(cell, capsys):
    """One short run of each cell on the card: correct, every metric there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args = ["--workload", cell, "--seed", str(2**31 + 3), "--seconds", "3", "--trace", "0",
            "--bench", str(ROOT / "BENCHMARK.json")]
    assert run.main(args) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {m["name"] for m in harness.load_cell(
        BENCH, cell, ROOT)["end_to_end"]}


@pytest.mark.parametrize("traffic, fault, caught_by", [
    ("present", "stale_proof", "repeated_proofs"),
    ("present", "altered_proof", "proofs_rejected"),
    ("prove", "altered_proof", "proofs_rejected"),
])
def test_a_broken_timed_path_is_not_correct(tmp_path, capsys, traffic, fault, caught_by):
    """The control: a run whose proof_generate returns its state unchanged
    (the previous proof) or alters the answer where it is produced (C + G)
    comes out not correct, by the number named."""
    rc, line, err = run_tiny(tmp_path, capsys, traffic=traffic, fault=fault)
    assert rc == 0 and line["correct"] is False
    assert line["checks"][caught_by]["value"] > 0
    assert err.strip().splitlines()[-1] == "correct = false"


def test_a_changed_circuit_is_not_correct(tmp_path, capsys, monkeypatch):
    """The program's circuit with a row more: its setup and its proofs
    agree with each other, and the reference, which builds the circuit
    itself, refuses the keys and the proofs."""
    from zklaim_tpu_torch.claims import api
    from zklaim_tpu_torch.r1cs.system import ONE

    class OneRowMore(api.ZKlaimCircuit):
        def __init__(self, num_payloads):
            super().__init__(num_payloads)
            self.cs.constrain(ONE, ONE, ONE, "a row the reference does not have")

    monkeypatch.setattr(api, "ZKlaimCircuit", OneRowMore)
    rc, line, err = run_tiny(tmp_path, capsys, traffic="present")
    assert rc == 0 and line["correct"] is False
    assert line["checks"]["key_mismatches"]["value"] > 0
    assert line["checks"]["proofs_rejected"]["value"] == line["checks"]["proofs_checked"]["value"]
    assert line["checks"]["status_mismatches"]["value"] > 0
