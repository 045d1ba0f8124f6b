"""utils.profiling of the port: PhaseTimer, device_trace, annotate, and the
timing helpers the measuring path uses.

Mirrors tests/test_store_profile.py:58-70 (the CSV schema and the counts)
and holds the port's PhaseTimer to the JAX package's on the same phases:
same CSV row apart from the measured times.  No tolerance: nothing numeric
is compared but the schema.
"""

import json

import pytest

import torch

from zklaim_tpu.utils import profiling as JP

from zklaim_tpu_torch.utils import profiling as TP

torch.set_num_threads(1)


def test_phase_timer_csv_schema():
    t = TP.PhaseTimer()
    with t.phase("issuer"):
        pass
    with t.phase("prover"):
        pass
    with t.phase("verifier"):
        pass
    row = t.csv_row(3, (100, 20, 5))
    fields = row.split(",")
    assert len(fields) == 8
    assert fields[1] == "3" and fields[5:] == ["100", "20", "5"]
    assert t.counts == {"issuer": 1, "prover": 1, "verifier": 1}


def test_phase_timer_matches_the_jax_package(monkeypatch):
    """Same accumulated times -> the same CSV row, field for field."""
    monkeypatch.setattr("time.time", lambda: 1_700_000_000)
    rows = []
    for mod in (JP, TP):
        t = mod.PhaseTimer()
        for name in ("issuer", "prover", "prover", "other"):
            with t.phase(name):
                pass
        assert t.counts == {"issuer": 1, "prover": 2, "other": 1}
        t.times_ms.update(issuer=1234.56, prover=78.94, verifier=0.04)
        rows.append(t.csv_row(2, (10228948, 904, 260)))
    assert rows[0] == rows[1] == "1700000000,2,1234.6,78.9,0.0,10228948,904,260"


def test_phase_timer_accumulates_and_survives_an_exception():
    t = TP.PhaseTimer()
    with pytest.raises(RuntimeError):
        with t.phase("prover"):
            raise RuntimeError("boom")
    with t.phase("prover"):
        pass
    assert t.counts == {"prover": 2} and t.times_ms["prover"] >= 0


@pytest.mark.parametrize("value,lines", [("1", 1), ("0", 0), ("", 0)])
def test_profile_lines_follow_the_environment(monkeypatch, capsys, value, lines):
    monkeypatch.setenv("ZKLAIM_PROFILE", value)
    with TP.PhaseTimer().phase("issuer"):
        pass
    err = capsys.readouterr().err
    assert err.count("[zklaim-profile] issuer:") == lines


def test_device_trace_without_a_directory_is_a_no_op(monkeypatch, tmp_path):
    monkeypatch.delenv("ZKLAIM_TRACE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with TP.device_trace("region"):
        torch.ones(4).sum()
    assert list(tmp_path.iterdir()) == []


def test_device_trace_writes_a_chrome_trace(monkeypatch, tmp_path):
    out = tmp_path / "traces"
    monkeypatch.setenv("ZKLAIM_TRACE_DIR", str(out))
    with TP.device_trace("region"):
        with TP.annotate("marked-region"):
            torch.ones(64).sum()
    trace = json.loads((out / "region.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "marked-region" in names


def test_annotate_outside_a_trace_is_harmless():
    with TP.annotate("nothing-listens"):
        assert torch.ones(2).sum().item() == 2


def test_best_ms_and_card_label_on_the_cpu():
    calls = []
    ms = TP.best_ms(lambda: calls.append(1), "cpu", runs=4)
    assert len(calls) == 5 and ms >= 0           # one warm-up call, then the runs
    assert TP.card_label("cpu") == "cpu"
    TP.sync("cpu")                               # nothing to wait for
