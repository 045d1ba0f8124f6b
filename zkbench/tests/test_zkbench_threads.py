"""The proving-service cell (n20.prove_x4) on the CPU: the threads loop
(loops/threads.py) on a made-up clock, the worker steps' holders, streams
and spans, the new readers, and a run of a tiny copy of the cell (the
zero-payload configuration, four threads) through run.main.

Run from the root of the repository:
    python -m pytest zkbench/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import json
import random
import threading
import time
import types
from pathlib import Path

import pytest
import torch

from zkbench import harness

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _loop():
    return harness.load_module(ROOT / "zkbench" / "loops" / "threads.py")


def test_threads_serve_unique_indices_and_stop_after_the_window(monkeypatch):
    """Request i ends at time i on its thread's clock (the loop reads the
    clock of the thread that asks), the window is 10: each of four threads
    stops after its first request that ends at or after 10, so the
    indices 0 ... 13 are each served once, every thread's last index is at
    least 10 and its others below, and the records come back in order."""
    loop = _loop()
    now = threading.local()
    monkeypatch.setattr(loop, "time", types.SimpleNamespace(
        perf_counter=lambda: getattr(now, "t", 0.0)))
    served = []
    rnd = random.Random(4)

    def request(i):
        time.sleep(rnd.random() * 2e-3)
        now.t = float(i)
        served.append((threading.current_thread().client, i))
        return {"index": i}

    records = loop.window(request, 10, {"clients": 4})
    assert [r["index"] for r in records] == list(range(14))
    assert sorted(i for _, i in served) == list(range(14))
    for k in range(4):
        mine = [i for client, i in served if client == k]
        assert mine and mine[-1] >= 10 and all(i < 10 for i in mine[:-1])


def test_an_error_in_a_thread_ends_the_window():
    loop = _loop()

    def request(i):
        if i == 5:
            raise ValueError("request 5")
        time.sleep(1e-3)
        return {"index": i}

    t0 = time.perf_counter()
    with pytest.raises(ValueError, match="request 5"):
        loop.window(request, 30, {"clients": 3})
    assert time.perf_counter() - t0 < 10
    assert not any(t.name.startswith("zkbench-client") for t in threading.enumerate())


def test_worker_steps_give_each_thread_its_own_holder_stream_and_spans():
    """Warm-up request i on the main thread is client i mod 4, so four
    warm-ups make the four clients' states: client 0's holder is
    roles.holder, another's a deep copy sharing the pk import; a window
    thread takes its client's state by the number it carries; only client 0
    records step spans."""
    claim = harness.load_module(ROOT / "zkbench" / "steps" / "worker_claim.py")

    class Holder:
        def __init__(self):
            self.cache = object()

        def __deepcopy__(self, memo):
            twin = Holder()
            twin.cache = self.cache
            return twin

    spans = []
    roles = types.SimpleNamespace(holder=Holder(), device="cpu",
                                  gen=types.SimpleNamespace(params={"clients": 4}),
                                  span=lambda name: spans.append(name) or _Null())
    warm = [claim.worker(roles, {"stream": "warmup", "index": i}) for i in range(4)]
    assert sorted(roles.workers) == [0, 1, 2, 3]
    assert [roles.workers[k] for k in range(4)] == warm
    assert warm[0].holder is roles.holder
    for mine in warm[1:]:
        assert mine.holder is not roles.holder and mine.holder.cache is roles.holder.cache
    assert all(mine.stream is None for mine in warm)          # the CPU: no stream
    got = {}

    def window(k):
        threading.current_thread().client = k
        rec = {"stream": "window", "index": 10 + k}
        got[k] = claim.worker(roles, rec)
        assert rec["client"] == k
        with got[k].span("claim"):
            pass

    for k in range(4):
        t = threading.Thread(target=window, args=(k,))
        t.start()
        t.join(10)
    assert [got[k] for k in range(4)] == warm                 # nothing made in the window
    assert spans == ["claim"]                                 # client 0 alone


@pytest.mark.parametrize("fault", ["stale_proof", "altered_proof"])
def test_a_fault_reaches_every_clients_holder(fault):
    """harness.inject breaks roles.holder after warm-up; each client's first
    window request puts the same fault into its copy, and only then."""
    claim = harness.load_module(ROOT / "zkbench" / "steps" / "worker_claim.py")
    from zklaim_tpu_torch.claims.api import Context

    roles = types.SimpleNamespace(holder=Context("cpu"), device="cpu",
                                  gen=types.SimpleNamespace(params={"clients": 3}),
                                  span=lambda name: _Null())
    for i in range(3):
        claim.worker(roles, {"stream": "warmup", "index": i})
    harness.inject(fault, roles)
    for k in range(3):
        assert "proof_generate" not in vars(roles.workers[k].holder) or k == 0
    for i in range(3):
        claim.worker(roles, {"stream": "window", "index": i})
    for k in range(3):
        assert vars(roles.workers[k].holder)["proof_generate"].__name__ == fault
    copy_fault = vars(roles.workers[1].holder)["proof_generate"]
    claim.worker(roles, {"stream": "window", "index": 4})     # once a client
    assert vars(roles.workers[1].holder)["proof_generate"] is copy_fault


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_the_new_readers():
    busy = harness.reader(ROOT, "busy_ms_per_proof").read
    assert busy({"kernel_count": 0, "busy_s": 0.0, "requests": 3}) is None
    assert busy({"kernel_count": 9, "busy_s": 0.0, "requests": 0}) is None
    assert busy({"kernel_count": 9, "busy_s": 0.5, "requests": 4}) == 125.0
    flight = harness.reader(ROOT, "holders_in_flight").read
    assert flight({"requests": 4}) is None                    # the recorder was off
    assert flight({"requests": 0, "counts": {"claims.in_flight": 3}}) is None
    assert flight({"requests": 4, "counts": {"claims.in_flight": 10}}) == 2.5
    names = {m["name"] for m in harness.load_cell(BENCH, "n20.prove_x4", ROOT)["per_layer"]}
    assert names == {"busy_ms_per_proof"}


def test_the_cells_config_is_n20_proved_by_four_holders():
    cell = harness.load_cell(BENCH, "n20.prove_x4", ROOT)
    n20 = json.loads((ROOT / "zkbench" / "configs" / "zklaim-n20.json").read_text())
    cfg = cell["config"]
    assert cfg["holders"] == cell["traffic"]["clients"] == 4
    assert (cfg["num_payloads"], cfg["sizes"], cfg["guarantees"], cfg["reduced"]) == (
        n20["num_payloads"], n20["sizes"], n20["guarantees"], [])
    assert set(n20["assumed"]) < set(cfg["assumed"])
    assert list(cell["steps"]) == ["worker_claim", "worker_prove"]
    assert cell["reference"].__name__ == "zkbench.reference.credential"
    assert {m["name"] for m in cell["end_to_end"]} == {"proofs_per_s", "setup_s"}


def _tiny_cell(tmp_path, warmup):
    import test_zkbench_harness as H

    bench_file = H._tiny_bench(tmp_path, "prove_x4")
    mix = tmp_path / "zkbench" / "traffic" / "tiny.json"
    mix.write_text(json.dumps({**json.loads(mix.read_text()), "check_sample": 64,
                               "warmup_requests": warmup}))
    return ["--workload", "tiny", "--seed", str(2**31 + 18), "--seconds", "0.5",
            "--trace", "0", "--bench", str(bench_file)]


def test_a_tiny_copy_of_the_cell(tmp_path, capsys):
    """The zero-payload configuration under the cell's mix (four threads,
    each its own holder): correct, every request's proof checked by the
    reference, the warm-up on the main thread's holder, and each window
    request on a copy of it."""
    from zkbench import run

    assert run.main(_tiny_cell(tmp_path, warmup=1), device="cpu") == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 4                             # a request a thread at least
    assert line["checks"]["proofs_checked"]["value"] == line["attempted"]
    assert line["checks"]["repeated_proofs"]["value"] == 0
    assert set(line["metrics"]) == {"proofs_per_s", "setup_s"}


@pytest.mark.parametrize("fault, caught_by", [("stale_proof", "repeated_proofs"),
                                              ("altered_proof", "proofs_rejected")])
def test_a_broken_timed_path_of_the_cell_is_not_correct(tmp_path, capsys, fault, caught_by):
    """The control runs of the cell: the warm-up makes all four holders, as
    the cell's mix does, and the fault injected after it breaks each of
    them, so the run comes out not correct by the number named; with
    altered proofs the reference refuses every proof it checks (a stale
    proof still verifies here: the zero-payload circuit has no public
    input)."""
    from zkbench import run

    mix = json.loads((ROOT / "zkbench" / "traffic" / "prove_x4.json").read_text())
    args = _tiny_cell(tmp_path, warmup=mix["warmup_requests"])
    assert run.main(args + ["--fault", fault], device="cpu") == 0
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    assert line["correct"] is False and line["checks"][caught_by]["value"] > 0
    checks = line["checks"]
    if fault == "altered_proof":                              # every holder's, not client 0's
        assert checks["proofs_rejected"]["value"] == checks["proofs_checked"]["value"] > 0
    assert out.err.strip().splitlines()[-1] == "correct = false"
