"""Port NTT (zklaim_tpu_torch.ntt) against the JAX package and Python ints.

The JAX side is radix2.NTTDomain's XLA path (its Pallas path is not run
on CPU); n stays small because that side is compile-bound.  Exact
equality throughout.
"""

import random

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from zklaim_tpu.ff.params import R
from zklaim_tpu.ntt import radix2 as JR

from zklaim_tpu_torch.ff import montgomery as TM
from zklaim_tpu_torch.ntt import gpu_ntt
from zklaim_tpu_torch.ntt.radix2 import NTTDomain

# The suite runs as several worker processes on a few cores; torch's
# intra-op threads would only contend with them.
torch.set_num_threads(1)


def _mont(vals):
    return torch.from_numpy(TM.encode_ints(TM.FR, vals).astype(np.int32))


def _ntt_stages(planes, tw, tile=gpu_ntt.TILE):
    """Every butterfly stage on (16, n) bit-reversed planes: K2's step and
    K3's, as a transform runs them after its entry."""
    return gpu_ntt.ntt_global(gpu_ntt.ntt_local(planes, tw, tile), tw, tile)


@pytest.fixture(scope="module")
def dom64():
    return JR.NTTDomain(64), NTTDomain(64, "cpu")


@pytest.mark.parametrize("op", ["ntt", "intt", "coset_ntt", "coset_intt"])
def test_transforms_match_jax(dom64, op):
    jd, td = dom64
    vals = [random.Random(9).randrange(R) for _ in range(64)]
    x = _mont(vals)
    want = getattr(jd, op)(jnp.asarray(x.numpy().astype(np.uint32)))
    np.testing.assert_array_equal(getattr(td, op)(x).numpy(), np.asarray(want).astype(np.int32))


def test_domain_tables_match_jax(dom64):
    jd, td = dom64
    np.testing.assert_array_equal(
        td.tw_flat.t().numpy(), np.concatenate(jd.stage_tw).astype(np.int32)
    )
    np.testing.assert_array_equal(
        td.tw_inv_flat.t().numpy(), np.concatenate(jd.stage_tw_inv).astype(np.int32)
    )
    np.testing.assert_array_equal(td.bitrev.numpy(), jd.bitrev)
    np.testing.assert_array_equal(td.shift_pows.numpy(), jd.shift_pows.astype(np.int32))
    np.testing.assert_array_equal(td.n_inv_mont.numpy(), jd.n_inv_mont.astype(np.int32))
    np.testing.assert_array_equal(td.z_coset_inv_mont.numpy(), jd.z_coset_inv_mont.astype(np.int32))


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_local_global_split_matches_dft(inverse):
    """n = 256 at tile 32: K2's plain stages (half < 32) and K3's (half >=
    32) both run; the result equals the single-tile run and a DFT in
    Python ints."""
    n = 256
    dom = NTTDomain(n, "cpu")
    vals = [random.Random(10).randrange(R) for _ in range(n)]
    planes = _mont(vals).index_select(0, dom.bitrev).t().contiguous()
    tw = dom.tw_inv_flat if inverse else dom.tw_flat
    split = _ntt_stages(planes, tw, tile=32)
    whole = _ntt_stages(planes, tw, tile=n)
    assert torch.equal(split, whole)
    root = dom.omega_inv if inverse else dom.omega
    want = [sum(v * pow(root, i * j, R) for j, v in enumerate(vals)) % R for i in range(n)]
    assert TM.decode_ints(TM.FR, split.t()) == want
    assert torch.equal(gpu_ntt.ntt_local(planes, tw, tile=32),
                       gpu_ntt.ntt_plain(planes, tw, range(5)))


def test_roundtrips_at_512():
    """The tiny circuit's domain size."""
    dom = NTTDomain(512, "cpu")
    x = _mont([random.Random(11).randrange(R) for _ in range(512)])
    assert torch.equal(dom.intt(dom.ntt(x)), x)
    assert torch.equal(dom.coset_intt(dom.coset_ntt(x)), x)


# ---------------------------------------------------------------------------
# K3's passes: the global stages in passes of columns
# ---------------------------------------------------------------------------

# (tile, stages a pass, columns a CTA): small tiles, so that several passes
# and several columns a CTA run at these sizes; the kernel takes any such split
SPLITS = [(4, 3, 4), (8, 2, 2), (2, 4, 1), (16, 5, 8)]


def _split(n, tile, per_pass, columns):
    """(s0, G, C) passes over the stages with half >= tile."""
    lt, k = min(tile, n).bit_length() - 1, n.bit_length() - 1
    return [(s0, min(per_pass, k - s0), min(columns, 1 << lt)) for s0 in range(lt, k, per_pass)]


def _planes(n, seed):
    return _mont([random.Random(seed).randrange(R) for _ in range(n)]).t().contiguous()


@pytest.mark.parametrize("log_n", range(6, 13))
def test_global_columns_plain_matches_ntt_plain(log_n):
    """ntt_global_columns_plain -- the kernel's passes, CTAs, pair and
    twiddle indices -- equals ntt_plain over the same stages, forward and
    inverse, for every split, and ntt_global on CPU planes is it."""
    n = 1 << log_n
    dom = NTTDomain(n, "cpu")
    x = _planes(n, log_n)
    for tile, per_pass, columns in SPLITS:
        passes = _split(n, tile, per_pass, columns)
        lt = min(tile, n).bit_length() - 1
        for tw in (dom.tw_flat, dom.tw_inv_flat):
            got = gpu_ntt.ntt_global_columns_plain(x, tw, tile, passes)
            assert torch.equal(got, gpu_ntt.ntt_plain(x, tw, range(lt, log_n))), (tile, passes)
    assert len(_split(n, 4, 3, 4)) == -(-(log_n - 2) // 3)
    for tile in (4, 32):                                  # global_passes' own split
        lt = min(tile, n).bit_length() - 1
        assert torch.equal(gpu_ntt.ntt_global(x, dom.tw_flat, tile),
                           gpu_ntt.ntt_plain(x, dom.tw_flat, range(lt, log_n)))


@pytest.mark.parametrize("log_n", [6, 12])
def test_column_passes_transform_matches_jax(dom64, log_n):
    """K2's stages below a tile of 4, then K3's in passes of at most 3
    stages on CTAs of up to 4 columns: the whole transform equals the JAX
    package's NTTDomain.ntt (2^6 reuses the module's domain; 2^12 compiles
    one more)."""
    n = 1 << log_n
    jd = dom64[0] if n == 64 else JR.NTTDomain(n)
    dom = NTTDomain(n, "cpu")
    vals = [random.Random(12).randrange(R) for _ in range(n)]
    x = _mont(vals)
    planes = x.index_select(0, dom.bitrev).t().contiguous()
    passes = _split(n, 4, 3, 4)
    local = gpu_ntt.ntt_plain(planes, dom.tw_flat, range(2))
    got = gpu_ntt.ntt_global_columns_plain(local, dom.tw_flat, 4, passes).t()
    want = jd.ntt(jnp.asarray(x.numpy().astype(np.uint32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int32))


def test_global_passes_at_the_paths_sizes():
    """One launch a transform at the credential path's 2^15 (5 stages, at
    least 132 CTAs), two at the bench's 2^20 and 2^22, at most 64 KiB of
    shared memory a CTA; none where every stage fits a tile."""
    assert gpu_ntt.global_passes(1 << 15) == [(10, 5, 4)]
    assert (1 << 15) // (4 << 5) >= gpu_ntt.MIN_CTAS
    assert gpu_ntt.global_passes(1 << 20) == [(10, 5, 32), (15, 5, 32)]
    assert gpu_ntt.global_passes(1 << 22) == [(10, 6, 32), (16, 6, 32)]
    for log_n in range(11, 23):
        passes = gpu_ntt.global_passes(1 << log_n)
        assert [s0 for s0, _, _ in passes] == [10 + sum(g for _, g, _ in passes[:i])
                                               for i in range(len(passes))]
        assert sum(g for _, g, _ in passes) == log_n - 10
        for s0, g, c in passes:
            assert (c << g) * 32 <= 64 * 1024 and g <= gpu_ntt.MAX_PASS_STAGES
    assert gpu_ntt.global_passes(1 << 10) == [] and gpu_ntt.global_passes(512) == []


# ---------------------------------------------------------------------------
# K2's clusters: a tile on a cluster of CTAs, the rows gathered in the load
# ---------------------------------------------------------------------------

# (tile, CTAs a cluster): small tiles, so that at these sizes every stage
# that pairs two CTAs runs, on clusters of 1 to 8 CTAs; (1024, 4) is the
# kernel's own split
CLUSTER_SPLITS = [(16, 4), (32, 2), (8, 8), (64, 8), (4, 1), (2, 2), (1024, 4)]


@pytest.mark.parametrize("log_n", range(6, 13))
def test_cluster_plain_matches_ntt_plain(log_n):
    """ntt_local_cluster_plain -- the kernel's CTA ranks, the stages that
    pair CTAs with their partner and twiddle indices, the staged twiddles,
    and for the rows entry the __brev row index -- equals ntt_plain over the
    stages below the tile, forward and inverse, for every split; ntt_local
    and ntt_local_rows on CPU tensors are the plain versions."""
    n = 1 << log_n
    dom = NTTDomain(n, "cpu")
    x = _mont([random.Random(20 + log_n).randrange(R) for _ in range(n)])
    planes = x.index_select(0, dom.bitrev).t().contiguous()
    for tile, cluster in CLUSTER_SPLITS:
        lt, lc, le = gpu_ntt.local_split(n, tile, cluster)
        assert (lt, lc + le) == (min(tile, n).bit_length() - 1, lt)
        for tw in (dom.tw_flat, dom.tw_inv_flat):
            want = gpu_ntt.ntt_plain(planes, tw, range(lt))
            assert torch.equal(gpu_ntt.ntt_local_cluster_plain(planes, tw, tile, cluster), want)
            assert torch.equal(gpu_ntt.ntt_local_cluster_plain(x, tw, tile, cluster, rows=True),
                               want), (tile, cluster)
            assert torch.equal(gpu_ntt.ntt_local_rows(x, tw, tile, cluster), want)
            assert torch.equal(gpu_ntt.ntt_local(planes, tw, tile, cluster), want)


@pytest.mark.parametrize("log_n", [6, 9, 12])
def test_cluster_plain_transform_matches_jax(dom64, log_n):
    """The rows entry's walk (bit reversal in the load, clusters of 4 CTAs
    on tiles of 16), then K3's passes: forward equals the JAX package's
    NTTDomain.ntt, and with the n^{-1} scaling the inverse equals its intt."""
    n = 1 << log_n
    jd = dom64[0] if n == 64 else JR.NTTDomain(n)
    dom = NTTDomain(n, "cpu")
    x = _mont([random.Random(30 + log_n).randrange(R) for _ in range(n)])
    xj = jnp.asarray(x.numpy().astype(np.uint32))
    for tw, ref in ((dom.tw_flat, jd.ntt(xj)), (dom.tw_inv_flat, jd.intt(xj))):
        local = gpu_ntt.ntt_local_cluster_plain(x, tw, 16, 4, rows=True)
        got = gpu_ntt.ntt_global_columns_plain(local, tw, 16).t()
        if tw is dom.tw_inv_flat:
            got = TM.mont_mul(TM.FR, got, dom.n_inv_mont)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref).astype(np.int32))


@pytest.mark.parametrize("log_n", [1, 2, 6, 9, 12])
def test_transform_entry_on_cpu_gives_the_planes_it_gave(log_n):
    """The rows entry on the CPU: bitrev_rows reverses the k bits of each
    index, ntt_local_rows gives the planes that the index_select, the
    transpose and the local stages gave, and NTTDomain.ntt / intt give what
    those planes through every stage gave."""
    n = 1 << log_n
    dom = NTTDomain(n, "cpu")
    x = _mont([random.Random(40 + log_n).randrange(R) for _ in range(n)])
    assert gpu_ntt.bitrev_rows(n, "cpu").tolist() == [
        int(format(j, f"0{log_n}b")[::-1], 2) for j in range(n)]
    planes = x.index_select(0, dom.bitrev).t().contiguous()
    lt = min(gpu_ntt.TILE, n).bit_length() - 1
    for tw in (dom.tw_flat, dom.tw_inv_flat):
        assert torch.equal(gpu_ntt.ntt_local_rows(x, tw), gpu_ntt.ntt_plain(planes, tw, range(lt)))
        assert torch.equal(gpu_ntt.ntt_local_rows(x, tw, bitrev=dom.bitrev),
                           gpu_ntt.ntt_plain(planes, tw, range(lt)))
    assert torch.equal(dom.ntt(x), _ntt_stages(planes, dom.tw_flat).t())
    assert torch.equal(dom.intt(x), TM.mont_mul(TM.FR, _ntt_stages(
        planes, dom.tw_inv_flat).t(), dom.n_inv_mont))


@pytest.mark.parametrize("log_n", [2, 11])
def test_transform_takes_a_strided_view(log_n):
    """A transform of a non-contiguous (n, 16) view (the transpose of
    planes) gives what it gives of the same values laid out in rows."""
    n = 1 << log_n
    dom = NTTDomain(n, "cpu")
    x = _mont([random.Random(60 + log_n).randrange(R) for _ in range(n)])
    view = x.t().contiguous().t()
    assert not view.is_contiguous()
    assert torch.equal(dom.ntt(view), dom.ntt(x))
    assert torch.equal(dom.coset_intt(view), dom.coset_intt(x))


def test_local_launch_at_the_paths_sizes():
    """Clusters of 4 CTAs of 256 elements and 128 threads: 128 CTAs at the
    credential path's 2^15 (one CTA a tile gave 32), 16,384 at the bench's
    2^22; a small transform takes a cluster of its own size; the rows entry
    refuses what is no (2^k, 16) rows tensor and splits refuse a cluster
    that is no power of two up to 8, or CTAs above 1,024 elements."""
    at = gpu_ntt.local_launch
    assert at(1 << 15) == {"cluster": 4, "ctas": 128, "threads": 128,
                           "shared_bytes": (256 + 255 + 2 * 128) * 32}
    assert at(1 << 15)["ctas"] >= 128 and at(1 << 22)["ctas"] == 16384
    assert at(1 << 15)["shared_bytes"] <= 48 * 1024
    assert at(4) == {"cluster": 2, "ctas": 2, "threads": 1, "shared_bytes": (2 + 1 + 1) * 32}
    assert at(2)["ctas"] == 1 and at(2)["threads"] == 1
    assert gpu_ntt.local_split(1 << 20) == (10, 2, 8)
    for bad in (3, 16, 0):
        with pytest.raises(ValueError):
            gpu_ntt.local_split(1 << 12, cluster=bad)
    assert gpu_ntt.local_split(1 << 12, 2048, 2) == (11, 1, 10)
    with pytest.raises(ValueError):                      # a CTA of 2,048 elements
        gpu_ntt.local_split(1 << 12, 2048, 1)
    tw = NTTDomain(8, "cpu").tw_flat
    for rows in (torch.zeros((8, 15), dtype=torch.int32), torch.zeros((6, 16), dtype=torch.int32)):
        with pytest.raises(ValueError):
            gpu_ntt.ntt_local_rows(rows, tw)
