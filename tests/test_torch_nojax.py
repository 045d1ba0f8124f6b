"""The port imports and runs without jax.

A subprocess blocks jax (sys.modules['jax'] = None), imports the port and
runs its main path on the small circuit on the CPU: setup, one proof, its
verification, the unsatisfied and wrong-input rejections.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_SCRIPT = """
import json, sys
sys.modules["jax"] = None
import torch
torch.set_num_threads(1)   # one of several test processes sharing the cores
import zklaim_tpu_torch
from zklaim_tpu_torch.groth16 import api
from zklaim_tpu_torch.entry import run_main_path
res = run_main_path("cpu", requests=1, seed=5, tiny=True)
res["jax_loaded"] = any(m == "jax" or m.startswith("jax.") for m, v in sys.modules.items() if v)
print(json.dumps(res))
"""


def test_main_path_runs_with_jax_blocked():
    out = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["verified"] == [True]
    assert res["unsatisfied_rejected"] and res["wrong_input_rejected"]
    assert (res["num_vars"], res["m"]) == (281, 512)
    assert not res["jax_loaded"]


def test_no_jax_import_in_port_sources():
    pat = re.compile(r"^\s*(import jax|from jax)", re.M)
    hits = [str(p) for p in (ROOT / "zklaim_tpu_torch").rglob("*.py") if pat.search(p.read_text())]
    assert hits == []
    assert not pat.search((ROOT / "chip_smoke.py").read_text())
