"""The cold holder's cell (n1.fresh_holder) on the CPU: the fresh_holder
step on a stand-in proof (a new context a request, built from the issuer's
wire bytes, the last one dropped before the next proves, the faults carried
over, the traced spans laid out), the new readers, and runs of a tiny copy
of the cell (the zero-payload configuration under the cell's mix) through
run.main: correct, the two controls not correct, and a traced run that
reads both new metrics.

Run from the root of the repository:
    python -m pytest zkbench/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import json
import random
import types
import weakref
from pathlib import Path

import pytest
import torch

from zkbench import harness, tracing
from zkbench.generator import Traffic

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
STEP = harness.load_module(ROOT / "zkbench" / "steps" / "fresh_holder.py")


def _roles(spans=None):
    """Roles of one payload with made-up credentials: enough for the step,
    whose proof_generate the test stands in for."""
    from zklaim_tpu_torch.claims.api import Context, Payload

    mix = json.loads((ROOT / "zkbench" / "traffic" / "fresh_holder.json").read_text())
    rng = random.Random(3)
    pool = [{"attrs": [[rng.randrange(1 << 20, 1 << 40) for _ in range(5)]],
             "pre": [rng.randbytes(48)], "salt": [rng.randrange(1 << 64)],
             "hash": [rng.randbytes(32)], "signature": rng.randbytes(64)} for _ in range(2)]
    issuer = {"pk": b"the pk's bytes", "vk": b"the vk's bytes", "pub_key": rng.randbytes(32)}
    holder = Context("cpu")
    return types.SimpleNamespace(Context=Context, Payload=Payload, device="cpu", pool=pool,
                                 issuer=issuer, holder=holder, spans=spans,
                                 gen=Traffic(mix, 1, 2**31 + 21), sync=lambda: None)


def _request(roles, i):
    rec = {"stream": "window", "index": i, "credential": i % len(roles.pool),
           "statuses": {}, "times": {}}
    rec["claim"] = roles.gen.claim("window", i, roles.pool[rec["credential"]]["attrs"])
    STEP.run(roles, rec)
    return rec


def test_each_request_proves_on_a_new_context_made_from_the_issuers_bytes(monkeypatch):
    """A new context a request: the credential's payloads, the issuer's vk,
    key and signature as deserialised from the issuer's wire bytes, the pk's
    bytes, the request's claim; the last request's context is gone (no
    collector run) before the next one proves."""
    from zklaim_tpu_torch.claims.api import Context

    made, dead = [], []

    def proof_generate(self, rng=None):
        dead.append([ref() is None for ref in made])
        made.append(weakref.ref(self))
        self.proof = bytes([len(made)]) * 260
        return 0

    monkeypatch.setattr(Context, "proof_generate", proof_generate)
    roles = _roles()
    for i in range(3):
        rec = _request(roles, i)
        holder, cred = roles.holder, roles.pool[i % 2]
        assert rec["statuses"] == {"prove": 0} and rec["proof"] == holder.proof
        assert made[-1]() is holder and holder.pk == roles.issuer["pk"]
        assert (holder.vk, holder.pub_key, holder.signature) == (
            roles.issuer["vk"], roles.issuer["pub_key"], cred["signature"])
        (pl,), ((refs, ops),) = holder.payloads, rec["claim"]
        assert (pl.pre, pl.salt, pl.hash) == (cred["pre"][0], cred["salt"][0], cred["hash"][0])
        assert (pl.data_ref, pl.data_op) == (refs, ops)
        del holder
    assert dead == [[], [True], [True, True]]
    assert len(roles.issuer_wires) == 2                     # made once, at the first call


@pytest.mark.parametrize("fault", ["stale_proof", "altered_proof"])
def test_a_fault_reaches_every_new_context(fault, monkeypatch):
    from zklaim_tpu_torch.claims.api import Context

    def proof_generate(self, rng=None):
        self.proof = b"ZKPF" + bytes(256)
        return 0

    monkeypatch.setattr(Context, "proof_generate", proof_generate)
    roles = _roles()
    harness.inject(fault, roles)                            # as run() does after warm-up
    for i in range(2):
        _request(roles, i)
        assert vars(roles.holder)["proof_generate"].__name__ == fault


def test_a_traced_request_lays_the_programs_spans_into_the_steps(monkeypatch):
    """Traced, the step span and the program's spans inside it become
    disjoint segments named by the innermost span."""
    from zklaim_tpu_torch.claims.api import Context
    from zklaim_tpu_torch.utils.profiling import span

    def proof_generate(self, rng=None):
        with span("claims.proof_generate"):
            with span("claims.pk_import"):
                with span("serde.pk_decode"):
                    pass
        self.proof = bytes(260)
        return 0

    monkeypatch.setattr(Context, "proof_generate", proof_generate)
    roles = _roles(spans=[])
    _request(roles, 0)
    names = [name for _, _, name in roles.spans]
    assert names[0] == names[-1] == "proof_generate"
    assert set(names) == {"proof_generate", "claims.proof_generate", "claims.pk_import",
                          "serde.pk_decode"}
    assert all(a[1] <= b[0] for a, b in zip(roles.spans, roles.spans[1:]))
    quiet = _roles()
    _request(quiet, 0)
    assert quiet.spans is None


def test_the_new_readers():
    for name, names in (("pk_import_idle_ms", ("claims.pk_import", "serde.pk_decode",
                                               "serde.pk_check", "groth16.qap")),
                        ("circuit_idle_ms", ("claims.circuit", "claims.witness_program"))):
        read = harness.reader(ROOT, name).read
        by_span = {n: 0.001 * (k + 1) for k, n in enumerate(names)}
        rec = {"kernel_count": 5, "requests": 2,
               "idle_s_by_span": {**by_span, "msm.tails": 1.0, "proof_generate": 2.0}}
        assert read(rec) == pytest.approx(1e3 * sum(by_span.values()) / 2)
        assert read({**rec, "idle_s_by_span": {"claims.proof_generate": 1.0}}) is None
        assert read({**rec, "kernel_count": 0}) is None     # no device activity traced
        assert read({**rec, "requests": 0}) is None
    cell = harness.load_cell(BENCH, "n1.fresh_holder", ROOT)
    assert {m["name"] for m in cell["per_layer"]} == {"pk_import_idle_ms", "circuit_idle_ms"}
    assert {m["name"] for m in cell["end_to_end"]} == {"proofs_per_s", "setup_s"}


def test_the_cells_config_is_n1_with_a_new_holder_a_request():
    cell = harness.load_cell(BENCH, "n1.fresh_holder", ROOT)
    n1 = json.loads((ROOT / "zkbench" / "configs" / "zklaim-n1.json").read_text())
    cfg = cell["config"]
    assert (cfg["num_payloads"], cfg["sizes"], cfg["guarantees"], cfg["reduced"],
            cfg["reference"]) == (n1["num_payloads"], n1["sizes"], n1["guarantees"], [],
                                  "credential")
    assert list(cell["steps"]) == ["claim", "fresh_holder", "present", "verify"]
    present = json.loads((ROOT / "zkbench" / "traffic" / "present.json").read_text())
    assert {k: v for k, v in cell["traffic"].items() if k not in ("steps", "warmup_requests")} \
        == {k: v for k, v in present.items() if k not in ("steps", "warmup_requests")}
    n20 = harness.load_cell(BENCH, "n20.present", ROOT)
    assert (n20["config"]["num_payloads"], list(n20["steps"])) == (
        20, ["claim", "prove", "present", "verify"])


class _CardEvent:
    """One kernel on the card, for the CPU's trace, which has none."""

    def __init__(self, start):
        self.start = start

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA

    def name(self):
        return "a kernel"

    def start_ns(self):
        return self.start

    def duration_ns(self):
        return 1


def _tiny(tmp_path, warmup):
    import test_zkbench_harness as H

    bench_file = H._tiny_bench(tmp_path, "fresh_holder")
    mix = tmp_path / "zkbench" / "traffic" / "tiny.json"
    mix.write_text(json.dumps({**json.loads(mix.read_text()), "warmup_requests": warmup}))
    return ["--workload", "tiny", "--seed", str(2**31 + 22), "--seconds", "0.5",
            "--bench", str(bench_file)]


def _line(capsys):
    out = capsys.readouterr()
    return json.loads(out.out.strip().splitlines()[-1]), out.err


def test_a_tiny_copy_of_the_cell(tmp_path, capsys):
    """The zero-payload configuration under the cell's mix: the warm-up's
    context and each window request's a new one; correct, every proof
    checked by the reference."""
    from zkbench import run

    assert run.main(_tiny(tmp_path, warmup=1) + ["--trace", "0"], device="cpu") == 0
    line, _ = _line(capsys)
    assert line["correct"] is True and line["failed"] == 0
    assert line["checks"]["proofs_checked"]["value"] == line["attempted"] >= 1
    assert set(line["metrics"]) == {"proofs_per_s", "setup_s"}


@pytest.mark.parametrize("fault, caught_by", [("stale_proof", "size_mismatches"),
                                              ("altered_proof", "proofs_rejected")])
def test_a_broken_timed_path_of_the_cell_is_not_correct(tmp_path, capsys, fault, caught_by):
    """The control runs: the fault injected after the warm-up reaches each
    window request's new context (a stale proof is the fresh context's
    none)."""
    from zkbench import run

    assert run.main(_tiny(tmp_path, warmup=0) + ["--trace", "0", "--fault", fault],
                    device="cpu") == 0
    line, err = _line(capsys)
    assert line["correct"] is False and line["checks"][caught_by]["value"] > 0
    assert err.strip().splitlines()[-1] == "correct = false"


def test_a_traced_run_reads_both_new_metrics(tmp_path, capsys, monkeypatch):
    """A traced run: the trace given one kernel at the window's start (the
    CPU's has none), the idle time after it is charged to the cold
    holder's stages, and the line holds both new metrics."""
    from zkbench import run

    seen = {}

    def record(events, window, spans, requests):
        seen["rec"] = tracing.record([_CardEvent(window[0])], window, spans, requests)
        return seen["rec"]

    monkeypatch.setattr(harness, "tracing",
                        types.SimpleNamespace(record=record, breakdown=tracing.breakdown))
    assert run.main(_tiny(tmp_path, warmup=0) + ["--trace", "1"], device="cpu") == 0
    line, _ = _line(capsys)
    assert line["correct"] is True
    assert set(line["metrics"]) == {"pk_import_idle_ms", "circuit_idle_ms"}
    assert all(m["value"] > 0 and m["unit"] == "ms/proof" for m in line["metrics"].values())
    idle = seen["rec"]["idle_s_by_span"]
    assert {"claims.pk_import", "serde.pk_decode", "serde.pk_check", "groth16.qap",
            "claims.circuit", "claims.witness_program", "msm.tails"} <= set(idle)
