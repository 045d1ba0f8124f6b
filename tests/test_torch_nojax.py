"""The port imports and runs without jax and without the JAX package.

A subprocess blocks both -- a sys.meta_path finder that raises on `jax`,
`jaxlib`, `zklaim_tpu` and anything below them -- imports the port and
runs, on the CPU, its Groth16 main path on the small circuit (setup, one
proof, its verification, the unsatisfied and wrong-input rejections) and
the zero-payload credential flow through claims.api.Context, imports the
measuring path (bench, parallel.prove, utils.profiling and every module of
tools) and drives one probe, and runs the two whole-loop dispatchers
(ff.montgomery.mont_pow_bits, msm.gpu_msm.finish) on CPU tensors, the
multi-device path on a mesh of one process (parallel.mesh, a sharded MSM
of two points, a four-step NTT round trip) and the legacy package (a
Lamport signature, the Merkle golden pairing, an ECDSA signature, the PoC
circuit's witness, a credential on a CPU Context).  The
source scan rejects any import of either
in the package and in chip_smoke.py.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

import zklaim_tpu_torch
import zklaim_tpu_torch.ff.params

ROOT = Path(__file__).resolve().parent.parent

_SCRIPT = """
import importlib.abc, json, sys

BLOCKED = ("jax", "jaxlib", "zklaim_tpu")


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked in this test")
        return None


sys.meta_path.insert(0, Block())
try:
    import zklaim_tpu.ff.params
    raise SystemExit("the block does not hold")
except ImportError:
    pass
import torch
torch.set_num_threads(1)   # one of several test processes sharing the cores
import zklaim_tpu_torch
from zklaim_tpu_torch import cli
from zklaim_tpu_torch.claims import api, serde, store
from zklaim_tpu_torch.entry import run_credential_path, run_main_path
from zklaim_tpu_torch import bench
from zklaim_tpu_torch.parallel import prove as parallel_prove
from zklaim_tpu_torch.utils import profiling
from zklaim_tpu_torch.tools import (
    grid_micro, layout_probe, mont_micro, msm_micro, msm_probe, msm_stages, padd_micro,
    pallas_micro, pallas_op_micro, prove_profile, scaling_bench, setup_profile, vpu_micro,
)
probe_rows = pallas_op_micro.measure("cpu", widths=(16,)) + mont_micro.measure("cpu", widths=(4,))
from zklaim_tpu_torch.ec import curve, rcb_schedule
from zklaim_tpu_torch.ff import montgomery
from zklaim_tpu_torch.msm import gpu_msm
x = torch.from_numpy(montgomery.encode_ints(montgomery.FQ, [0, 1, 7]).astype("int32"))
inverses = montgomery.decode_ints(montgomery.FQ, montgomery.mont_inv(montgomery.FQ, x))
infinity = curve.infinity_planes(1, 16, "cpu")
finished = gpu_msm.finish(1, infinity, infinity, 16, 1)
schedule_words = len(rcb_schedule.pack(rcb_schedule.finish_schedule(2)))
ntt_row = bench.bench_ntt(3, runs=1, device="cpu")
import hashlib, random
from zklaim_tpu_torch.entry import multiple_rows, random_scalars
from zklaim_tpu_torch.parallel import mesh as pmesh, msm as pmsm, ntt as pntt
from zklaim_tpu_torch.legacy import cred, ecdsa_secp256k1, lamport, merkle, poc_circuit
one = pmesh.make_mesh(device="cpu")
rows, _ = multiple_rows(2, "cpu")
sharded = pmsm.sharded_msm(pmesh.make_host_mesh(device="cpu"), 1, rows,
                           torch.ones((2, 16), dtype=torch.int32) * (torch.arange(16) == 0),
                           axis=("host", "chip"))
plan = pntt.ShardedNTT(one, 16)
xs = montgomery.to_mont(montgomery.FR, random_scalars(16, __import__("numpy").random.default_rng(1), "cpu"))
round_trip = bool(torch.equal(plan.intt_t(plan.ntt_t(plan.to_matrix(xs))).reshape(16, 16), xs))
lrng = random.Random(3)
priv, pub = lamport.create_private_key(lrng)
msg = hashlib.sha256(b"m").digest()
d = ecdsa_secp256k1.keygen(lrng)
poc = poc_circuit.PocCircuit()
legacy_ok = [lamport.verify(msg, pub, lamport.sign(msg, priv)),
             ecdsa_secp256k1.ecdsa_verify(b"m", ecdsa_secp256k1.ecdsa_sign(b"m", d, lrng),
                                          ecdsa_secp256k1._mul(d, ecdsa_secp256k1.G)),
             merkle.build_tree([msg, msg]).root_hash == hashlib.sha256(msg + msg).digest(),
             poc.cs.is_satisfied(poc.witness(poc.make_preimage(age=20, salary=60000))),
             cred.TestCredential(issuer=1, subject=2, cred_type=0, employee_id=5,
                                 context=api.Context(device="cpu")).context.payloads[0].pre[0] == 5]
res = run_main_path("cpu", requests=1, seed=5, tiny=True)
cred = run_credential_path("cpu", num_payloads=0, requests=1, seed=5)
res["credential_statuses_ok"] = cred["statuses_ok"]
res["credential_verify"] = cred["status"]["verify"]
res["probe_devices"] = sorted({r["device"] for r in probe_rows})
res["ntt_metric"] = ntt_row["metric"]
res["inverses"] = [str(v) for v in inverses]
res["finish_is_infinity"] = bool(torch.equal(finished, curve.infinity_planes(1, 1, "cpu")))
res["schedule_words"] = schedule_words
res["sharded_msm"] = str(curve.planes_to_host_points(1, sharded)[0])
res["sharded_ntt_round_trip"] = round_trip
res["legacy_ok"] = legacy_ok
res["foreign"] = sorted(m for m, v in sys.modules.items()
                        if v is not None and m.split(".")[0] in BLOCKED)
print(json.dumps(res))
"""


def test_main_path_runs_with_jax_blocked():
    out = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT, capture_output=True,
                         text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["verified"] == [True]
    assert res["unsatisfied_rejected"] and res["wrong_input_rejected"]
    assert (res["num_vars"], res["m"]) == (281, 512)
    assert res["credential_statuses_ok"] and res["credential_verify"] == [0]
    assert res["probe_devices"] == ["cpu"] and res["ntt_metric"] == "ntt_fr_2^3_elems_per_sec"
    q = zklaim_tpu_torch.ff.params.Q
    assert res["inverses"] == ["0", "1", str(pow(7, q - 2, q))]
    assert res["finish_is_infinity"] and res["schedule_words"] > 100
    from zklaim_tpu_torch.ec.hostcurve import g1_generator

    assert res["sharded_msm"] == str(g1_generator() * 3)      # 1 G + 2 G
    assert res["sharded_ntt_round_trip"] and res["legacy_ok"] == [True] * 5
    assert res["foreign"] == []


def test_no_jax_import_in_port_sources():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|zklaim_tpu)\b", re.M)
    assert pat.search("from zklaim_tpu.ff import params") and pat.search("  import jax.numpy")
    assert not pat.search("from zklaim_tpu_torch.ff import params")
    hits = [str(p) for p in (ROOT / "zklaim_tpu_torch").rglob("*.py") if pat.search(p.read_text())]
    assert hits == []
    assert not pat.search((ROOT / "chip_smoke.py").read_text())


def test_default_device_raises_without_cuda():
    """The card is the default and is never silently replaced by the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        zklaim_tpu_torch.default_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        zklaim_tpu_torch.resolve_device(None)
    assert zklaim_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    from zklaim_tpu_torch.entry import run_credential_path, run_main_path

    for entry_point in (run_main_path, run_credential_path):
        with pytest.raises(RuntimeError, match="CUDA"):
            entry_point()
