"""The multi-device path (zklaim_tpu_torch.parallel) on a 4-process gloo
group on the CPU, and the mesh plumbing with the process group faked.

One module fixture spawns four ranks (torch.multiprocessing, a file://
store under a temporary directory, so nothing listens on a port; gloo with
a 60 s timeout) laid out on two hosts, h0 = {0, 1} and h1 = {2, 3}, by the
host name each rank reports.  Each rank runs the jobs below, saves its results and leaves;
the fixture joins them within a deadline and kills them past it, so a hung
rendezvous or collective fails the tests instead of eating the suite's
time limit.  Meanwhile the parent computes what the results are held to:

  - run_multichip at the JAX dryrun's tiny shapes (16 points, c = 4, an
    NTT of 64), its batched prove on the two-constraint circuit: the
    sharded MSM over the 1-D mesh and over the (2, 2) host mesh equals the
    port's local msm and the host's sum, in affine;
  - sharded_msm on 18 points refuses 4 shards, on every rank;
  - ShardedNTT at n = 64: from_transposed(ntt_t(x)) equals the JAX
    package's get_domain(64).ntt(x), intt_t returns x, a pointwise square
    in transposed order equals the local pipeline's, and the twiddle
    columns built on each rank equal the JAX package's host table;
  - tools/scaling_bench at S = 1, 2, 4 (the world's size stops it before
    8) on 16 points: a row each, rank 0 writes the table;
  - batched_prove of 6 witnesses over 4 ranks (padded to 8, two waves)
    gives on every rank the bytes of 6 successive `prove` calls from the
    same seed, and they verify; a batch with an unsatisfied witness raises
    ValueError naming it on every rank, and no rank hangs.

The tests of init_distributed, host grouping and shard order run in the
test process with torch.distributed.init_process_group faked, as
tests/test_mesh.py fakes jax.distributed.initialize.  Integer arithmetic:
tolerance 0 throughout.
"""

import random
import socket
import time
from pathlib import Path

import numpy as np
import pytest

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from zklaim_tpu_torch.parallel import mesh as MESH

torch.set_num_threads(1)

WORLD = 4
SEED = 20260817
NTT_N = 64
DEADLINE_S = 240


def _small_system():
    """x * y = z, z * z = out with out public: (cs, witness function)."""
    from zklaim_tpu_torch.r1cs.system import ConstraintSystem

    cs = ConstraintSystem()
    out = cs.alloc_lc()
    cs.mark_primary_end()
    x, y, z = cs.alloc_lc(), cs.alloc_lc(), cs.alloc_lc()
    cs.constrain(x, y, z, "xy")
    cs.constrain(z, z, out, "zz")

    def witness(xv, yv, outv=None):
        def init(w):
            zv = xv * yv
            for lc, v in ((x, xv), (y, yv), (z, zv), (out, zv * zv if outv is None else outv)):
                w[next(iter(lc.terms))] = v
        return cs.generate_witness(init)

    return cs, witness


def _batch(witness):
    return [witness(3, 5), witness(2, 7)] * 3


def _ntt_input():
    from zklaim_tpu_torch.entry import random_scalars
    from zklaim_tpu_torch.ff import montgomery as M

    return M.to_mont(M.FR, random_scalars(NTT_N, np.random.default_rng(64), "cpu"))


def _worker(rank, world, store, out_dir):
    """One rank: every job, its results saved to out_dir/rank<r>.pt."""
    from zklaim_tpu_torch.claims import serde
    from zklaim_tpu_torch.entry import multiple_rows, run_multichip
    from zklaim_tpu_torch.ff import montgomery as M
    from zklaim_tpu_torch.groth16.api import setup
    from zklaim_tpu_torch.parallel.msm import sharded_msm
    from zklaim_tpu_torch.parallel.ntt import ShardedNTT
    from zklaim_tpu_torch.parallel.prove import batched_prove
    from zklaim_tpu_torch.tools import scaling_bench

    torch.set_num_threads(1)
    assert MESH.init_distributed(f"file://{store}", world, rank, device="cpu", timeout_s=60)
    socket.gethostname = lambda: f"h{rank // 2}"        # two hosts of two ranks
    mesh = MESH.make_mesh()
    res = {"backend": dist.get_backend()}
    cs, witness = _small_system()

    mc = run_multichip(mesh, "cpu", circuit=(cs, witness(3, 5)), msm_c=4, seed=SEED)
    res["multichip"] = {k: mc[k] for k in ("msm_1d", "msm_2d", "verified", "host_mesh", "shards")}
    res["multichip"]["proofs"] = [serde.proof_to_bytes(p) for p in mc["proofs"]]

    rows, _ = multiple_rows(18, "cpu")
    try:
        sharded_msm(mesh, 1, rows, torch.zeros((18, 16), dtype=torch.int32), 4)
    except ValueError as err:
        res["bad_shards"] = str(err)

    plan = ShardedNTT(mesh, NTT_N)
    x = _ntt_input()
    z = plan.ntt_t(plan.to_matrix(x))
    res["ntt"] = {"tw": plan.tw, "tw_inv": plan.tw_inv, "index": plan.index,
                  "evals": plan.from_transposed(z), "back": plan.intt_t(z).reshape(NTT_N, 16),
                  "square": plan.intt_t(M.mont_mul(M.FR, z, z)).reshape(NTT_N, 16)}

    pk, vk, qap = setup(cs, random.Random(11), "cpu")
    proofs = batched_prove(mesh, pk, qap, _batch(witness), random.Random(99), msm_c=4)
    res["batch"] = [serde.proof_to_bytes(p) for p in proofs]
    bad = [witness(3, 5), witness(2, 7), witness(3, 5, outv=226), witness(2, 7),
           witness(2, 7, outv=1)]
    try:
        batched_prove(mesh, pk, qap, bad, random.Random(1), msm_c=4)
    except ValueError as err:
        res["unsatisfied"] = str(err)
    sb = scaling_bench.measure("cpu", log2n=4, repeats=1)
    res["scaling"] = {"rows": sb, "written": [str(p) for p in scaling_bench.write(
        sb, Path(out_dir) / "scaling")]}
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")
    dist.destroy_process_group()


def _expected():
    """What the ranks' results are held to, computed in the test process."""
    from zklaim_tpu_torch.claims import serde
    from zklaim_tpu_torch.ec import curve as C
    from zklaim_tpu_torch.ec.hostcurve import g1_generator
    from zklaim_tpu_torch.entry import multiple_rows, random_scalars
    from zklaim_tpu_torch.groth16 import api
    from zklaim_tpu_torch.msm.pippenger import msm

    rows, k = multiple_rows(16, "cpu")
    scalars = random_scalars(16, np.random.default_rng(SEED), "cpu")
    ints = [int.from_bytes(r.astype("<u2").tobytes(), "little") for r in scalars.numpy()]
    host = g1_generator() * (sum(s * m for s, m in zip(ints, k)) % api.R)
    local = C.planes_to_host_points(1, msm(1, rows, scalars, 4))[0]

    # successive proves: the sums of a witness are a pure function of it,
    # so the two distinct witnesses' sums are computed once each
    cs, witness = _small_system()
    pk, vk, qap = api.setup(cs, random.Random(11), "cpu")
    sums, computed = api.prove_sums, {}

    def shared(pk, w_plain, h, msm_c=8):
        key = (w_plain.numpy().tobytes(), msm_c)
        if key not in computed:
            computed[key] = sums(pk, w_plain, h, msm_c)
        return computed[key]

    api.prove_sums = shared
    try:
        rng = random.Random(99)
        one_by_one = [serde.proof_to_bytes(api.prove(pk, qap, w, rng, msm_c=4))
                      for w in _batch(witness)]
    finally:
        api.prove_sums = sums
    verified = [api.verify(vk, [225 if i % 2 == 0 else 196], serde.proof_from_bytes(b))
                for i, b in enumerate(one_by_one)]
    return {"host": host, "local": local, "one_by_one": one_by_one, "verified": verified,
            "jax_ntt": _jax_ntt()}


def _jax_ntt():
    """The JAX package's get_domain(NTT_N).ntt of the NTT input."""
    import jax.numpy as jnp

    from zklaim_tpu.ntt.radix2 import get_domain

    x = _ntt_input().numpy().astype(np.uint32)
    return np.asarray(get_domain(NTT_N).ntt(jnp.asarray(x))).astype(np.int32)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    out = tmp_path_factory.mktemp("gloo")
    ctx = mp.start_processes(_worker, args=(WORLD, str(out / "store"), str(out)),
                             nprocs=WORLD, join=False, start_method="spawn")
    t0 = time.monotonic()
    try:
        expected = _expected()
        while not ctx.join(timeout=1):
            if time.monotonic() - t0 > DEADLINE_S:
                raise TimeoutError(f"the {WORLD} ranks did not finish in {DEADLINE_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return ranks, expected


def test_ranks_ran_on_gloo(group):
    ranks, _ = group
    assert [r["backend"] for r in ranks] == ["gloo"] * WORLD


@pytest.mark.parametrize("which", ["msm_1d", "msm_2d"])
def test_sharded_msm_equals_local_msm_and_host_sum(group, which):
    ranks, want = group
    assert want["local"] == want["host"] and not want["host"].inf
    for r in ranks:
        assert r["multichip"][which] == want["host"]
    assert all(r["multichip"]["host_mesh"] == (2, 2) for r in ranks)


def test_sharded_msm_rejects_bad_shard_count(group):
    ranks, _ = group
    assert all(r["bad_shards"] == "point count 18 not divisible by 4 shards" for r in ranks)


def test_sharded_ntt_matches_jax(group):
    ranks, want = group
    x = _ntt_input()
    for r in ranks:
        np.testing.assert_array_equal(r["ntt"]["evals"].numpy(), want["jax_ntt"])
        assert torch.equal(r["ntt"]["back"], x)


def test_sharded_ntt_pointwise_square_matches_local_pipeline(group):
    from zklaim_tpu_torch.ff import montgomery as M
    from zklaim_tpu_torch.ntt.radix2 import get_domain

    ranks, _ = group
    dom = get_domain(NTT_N, "cpu")
    y = dom.ntt(_ntt_input())
    want = dom.intt(M.mont_mul(M.FR, y, y))
    for r in ranks:
        assert torch.equal(r["ntt"]["square"], want)


def test_device_twiddle_matrix_equals_jax_host_table(group):
    from zklaim_tpu.parallel.mesh import make_mesh
    from zklaim_tpu.parallel.ntt import ShardedNTT as JaxShardedNTT

    ranks, _ = group
    jplan = JaxShardedNTT(make_mesh(WORLD), NTT_N)
    cols = jplan.n2 // WORLD
    for r in sorted(ranks, key=lambda r: r["ntt"]["index"]):
        i = r["ntt"]["index"]
        for mine, theirs in ((r["ntt"]["tw"], jplan.tw), (r["ntt"]["tw_inv"], jplan.tw_inv)):
            np.testing.assert_array_equal(mine.numpy(),
                                          theirs[:, i * cols : (i + 1) * cols].astype(np.int32))
    assert sorted(r["ntt"]["index"] for r in ranks) == list(range(WORLD))


def test_batched_prove_over_four_ranks_gives_successive_proofs(group):
    ranks, want = group
    assert len(want["one_by_one"]) == 6 and len(set(want["one_by_one"])) == 6
    assert all(want["verified"])
    for r in ranks:
        assert r["batch"] == want["one_by_one"]


def test_unsatisfied_witness_raises_on_every_rank(group):
    ranks, _ = group
    for r in ranks:
        assert r["unsatisfied"] == "witness 2 unsatisfied: (1, 'zz')"


def test_run_multichip_proofs_verify(group):
    ranks, _ = group
    for r in ranks:
        assert r["multichip"]["verified"] == [True] * WORLD
        assert r["multichip"]["shards"] == WORLD
        assert r["multichip"]["proofs"] == ranks[0]["multichip"]["proofs"]


def test_scaling_bench_rows_up_to_the_world(group):
    ranks, _ = group
    for rank, r in enumerate(ranks):
        sb = r["scaling"]["rows"]
        member = [s for s in (1, 2, 4) if rank < s]          # the meshes of the first S ranks
        assert sb["world"] == WORLD and sb["log2n"] == 4 and sb["rank"] == rank
        assert [row["shards"] for row in sb["msm"]] == member
        assert [row["points_per_rank"] for row in sb["msm"]] == [16 // s for s in member]
        assert [row["shards"] for row in sb["ntt"]] == member
        assert all(row["wall_s"] > 0 for row in sb["msm"])
    written = ranks[0]["scaling"]["written"]
    assert [Path(w).suffix for w in written] == [".json", ".md"]
    assert "| 4 | 4 |" in Path(written[1]).read_text()
    assert all(r["scaling"]["written"] == [] for r in ranks[1:])


# -- the mesh plumbing, with the process group faked ----------------------------


@pytest.fixture
def fake_init(monkeypatch):
    MESH._DIST_STATE.clear()
    MESH._DIST_STATE["initialized"] = False
    for var in ("ZKLAIM_COORDINATOR", "ZKLAIM_NUM_PROCESSES", "ZKLAIM_PROCESS_ID",
                "MASTER_ADDR", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    called = []
    monkeypatch.setattr(dist, "init_process_group", lambda **kw: called.append(kw))
    yield called
    MESH._DIST_STATE.clear()
    MESH._DIST_STATE["initialized"] = False


def _no_timeout(calls):
    return [{k: v for k, v in kw.items() if k != "timeout"} for kw in calls]


def test_init_distributed_noop_without_config(fake_init):
    assert MESH.init_distributed() is False
    assert fake_init == []


def test_init_distributed_explicit_args(fake_init):
    assert MESH.init_distributed("10.0.0.1:1234", 4, 2, device="cpu") is True
    assert _no_timeout(fake_init) == [{"backend": "gloo", "init_method": "tcp://10.0.0.1:1234",
                                       "world_size": 4, "rank": 2}]
    assert MESH.init_distributed() is True          # idempotent
    assert len(fake_init) == 1


def test_init_distributed_env_resolution(fake_init, monkeypatch):
    monkeypatch.setenv("ZKLAIM_COORDINATOR", "coord:9999")
    monkeypatch.setenv("ZKLAIM_NUM_PROCESSES", "8")
    monkeypatch.setenv("ZKLAIM_PROCESS_ID", "3")
    assert MESH.init_distributed(device="cpu") is True
    assert _no_timeout(fake_init) == [{"backend": "gloo", "init_method": "tcp://coord:9999",
                                       "world_size": 8, "rank": 3}]


def test_init_distributed_torchrun_and_file_store(fake_init, monkeypatch, tmp_path):
    """torchrun's variables take the place of the TPU pod's; an address with
    a scheme is passed as it is; the backend follows the device."""
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert MESH.init_distributed(device="cpu") is True
    assert _no_timeout(fake_init) == [{"backend": "gloo", "init_method": "env://"}]
    MESH._DIST_STATE["initialized"] = False
    assert MESH.init_distributed(f"file://{tmp_path}/s", 1, 0, device="cpu")
    assert fake_init[-1]["init_method"] == f"file://{tmp_path}/s"
    assert MESH._backend(torch.device("cuda", 0)) == "nccl"
    assert MESH._backend(torch.device("cpu")) == "gloo"


def test_init_distributed_without_cuda_raises(fake_init, monkeypatch):
    """Configured but given no device, a rank takes a card, and without one
    it raises rather than fall back to the CPU; so does rank_device()."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MESH.init_distributed()
    assert fake_init == [] and MESH._DIST_STATE == {"initialized": False}
    with pytest.raises(RuntimeError):
        MESH.rank_device()
    with pytest.raises(RuntimeError):
        MESH.make_mesh()


def test_host_grid_groups_by_host():
    grid = MESH.host_grid(["a"] * 4 + ["b"] * 4)
    assert grid.tolist() == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert MESH.host_grid(["a", "b", "a", "b"]).tolist() == [[0, 2], [1, 3]]
    with pytest.raises(ValueError):
        MESH.host_grid(["a", "a", "b"])


def test_make_host_mesh_single_process_degenerates():
    m = MESH.make_host_mesh(device="cpu")
    assert m.devices.shape == (1, 1) and m.axis_names == ("host", "chip")
    assert MESH.flat_shard_axis(m) == ("host", "chip")
    assert MESH.flat_shard_axis(MESH.make_mesh(device="cpu")) == ("shards",)
    x = torch.arange(16, dtype=torch.int32)
    assert torch.equal(m.all_gather(x, ("host", "chip")), x[None])
    with pytest.raises(ValueError):
        MESH.make_mesh(2, device="cpu")


def test_shard_order_over_tuple_axes(monkeypatch):
    """Rank 2 of the grid [[0, 2], [1, 3]] sits at (host 0, chip 1): shard 1
    of ('host', 'chip') (host major), 2 of ('chip', 'host'), 1 of 'chip', 0
    of 'host'."""
    monkeypatch.setattr(MESH, "world", lambda: (2, 4))
    m = MESH.Mesh(np.array([[0, 2], [1, 3]]), ("host", "chip"), "cpu")
    assert m.axis_size(("host", "chip")) == 4 and m.axis_size("chip") == 2
    assert m.shard_index(("host", "chip")) == 1
    assert m.shard_index(("chip", "host")) == 2
    assert m.shard_index("chip") == 1 and m.shard_index("host") == 0
    assert m._members(("host", "chip")).tolist() == [0, 2, 1, 3]
