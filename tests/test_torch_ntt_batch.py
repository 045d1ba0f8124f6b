"""Batched transforms: the port's NTTDomain on (n, B, 16) against the JAX
package's, and the batched plain versions of K2 and K3.

  - NTTDomain.{ntt, intt, coset_ntt, coset_intt} transform along axis 0 of
    (n, ..., 16) in both packages.  For each n the JAX side runs once, on
    the B = 1, 3 and 8 inputs stacked along axis 1 (a (n, 12, 16) input:
    its transforms act on each column alone, so each case is a slice of it;
    its XLA path is compile-bound on the CPU, one compile a shape), and the
    port runs each B on its own.  n = 2^11 crosses into K3's stages.
  - The batched plain versions -- ntt_plain, ntt_local_cluster_plain (both
    entries) and ntt_global_columns_plain on (16, B n) planes -- equal B
    one-transform calls, at tiles and clusters small enough to run every
    cross-CTA stage and several K3 passes.
  - The split at the four-step shapes: 128 transforms of 256 and 256 of
    128 (2^15), 2,048 of 2,048 (2^22): the launch K2 makes and K3's passes,
    and the walks of both at the 2^15 shapes (and K3's at the 2^22
    geometry on two transforms) against ntt_plain.
Integer arithmetic throughout: tolerance 0.
"""

from functools import lru_cache

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from zklaim_tpu.ntt import radix2 as JR

from zklaim_tpu_torch.ff import montgomery as TM
from zklaim_tpu_torch.ntt import gpu_ntt
from zklaim_tpu_torch.ntt.radix2 import NTTDomain

torch.set_num_threads(1)

OPS = ("ntt", "intt", "coset_ntt", "coset_intt")
BATCHES = (1, 3, 8)


def _fr(shape, seed):
    """Random canonical Fr limbs (below r: the top limb under 0x3064)."""
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 1 << 16, size=shape + (16,))
    v[..., 15] = rng.integers(0, 0x3064, size=shape)
    return v.astype(np.int32)


@lru_cache(maxsize=None)
def _jax_results(n: int):
    """(stacked input, {op: JAX result}) on (n, 1 + 3 + 8, 16)."""
    x = _fr((n, sum(BATCHES)), n)
    dom = JR.NTTDomain(n)
    xj = jnp.asarray(x.astype(np.uint32))
    return x, {op: np.asarray(getattr(dom, op)(xj)).astype(np.int32) for op in OPS}


@pytest.mark.parametrize("n", [2, 4, 1 << 8, 1 << 11])
@pytest.mark.parametrize("batch", BATCHES)
def test_batched_transforms_match_jax(n, batch):
    x, want = _jax_results(n)
    col = BATCHES[: BATCHES.index(batch)]
    cols = slice(sum(col), sum(col) + batch)
    dom = NTTDomain(n, "cpu")
    xt = torch.from_numpy(np.ascontiguousarray(x[:, cols]))
    for op in OPS:
        got = getattr(dom, op)(xt)
        assert got.shape == (n, batch, 16)
        np.testing.assert_array_equal(got.numpy(), want[op][:, cols], err_msg=op)
    # more batch axes than one: (n, 2, 4, 16) is the B = 8 case, reshaped
    if batch == 8:
        got = dom.coset_ntt(xt.reshape(n, 2, 4, 16))
        np.testing.assert_array_equal(got.reshape(n, 8, 16).numpy(), want["coset_ntt"][:, cols])


def _one_by_one(fn, planes, n):
    """fn on each segment of n of (16, B n) planes, concatenated."""
    return torch.cat([fn(planes[:, b * n : (b + 1) * n].contiguous())
                      for b in range(planes.shape[1] // n)], dim=1)


@pytest.mark.parametrize("n,batch,tile,cluster", [(2, 3, 1024, 4), (4, 5, 1024, 4),
                                                  (64, 3, 16, 4), (256, 3, 32, 8),
                                                  (256, 2, 4, 2)])
def test_batched_plain_versions_equal_one_transform_calls(n, batch, tile, cluster):
    dom = NTTDomain(n, "cpu")
    lt = min(tile, n).bit_length() - 1
    rows = torch.from_numpy(_fr((n, batch), 7 + n))
    for tw in (dom.tw_flat, dom.tw_inv_flat):
        planes = rows.index_select(0, dom.bitrev).permute(2, 1, 0).reshape(16, batch * n)
        planes = planes.contiguous()
        want = _one_by_one(lambda p: gpu_ntt.ntt_plain(p, tw, range(lt)), planes, n)
        assert torch.equal(gpu_ntt.ntt_plain(planes, tw, range(lt)), want)
        assert torch.equal(gpu_ntt.ntt_local_cluster_plain(planes, tw, tile, cluster, n=n), want)
        assert torch.equal(gpu_ntt.ntt_local_cluster_plain(rows, tw, tile, cluster, rows=True),
                           want)
        assert torch.equal(gpu_ntt.ntt_local_rows(rows, tw, tile, cluster), want)
        assert torch.equal(gpu_ntt.ntt_local(planes.clone(), tw, tile, cluster, n=n), want)
        full = _one_by_one(lambda p: gpu_ntt.ntt_plain(p, tw, range(dom.k)), planes, n)
        got = gpu_ntt.ntt_global_columns_plain(want, tw, tile, n=n)
        assert torch.equal(got, full)
        assert torch.equal(gpu_ntt.ntt_global(want.clone(), tw, tile, n=n), full)
    if n >= 64:
        assert gpu_ntt.global_passes(n, tile, batch)        # K3 has stages to run here


def test_split_at_the_four_step_shapes():
    """2^15: 128 transforms of 256 (columns) and 256 of 128 (rows), K2
    alone; 2^22: 2,048 of 2,048, K2 and one K3 pass.  A batch launches as
    many CTAs as its width asks, in the clusters of one transform."""
    assert gpu_ntt.local_launch(256, batch=128) == {
        "cluster": 4, "ctas": 512, "threads": 32, "shared_bytes": (64 + 63 + 2 * 32) * 32}
    assert gpu_ntt.local_launch(128, batch=256)["ctas"] == 1024
    assert gpu_ntt.local_launch(2048, batch=2048)["ctas"] == (1 << 22) // 256
    assert gpu_ntt.local_launch(2048) == dict(gpu_ntt.local_launch(2048, batch=2048),
                                              ctas=2048 // 256)
    assert gpu_ntt.global_passes(256, batch=128) == gpu_ntt.global_passes(128, batch=256) == []
    assert gpu_ntt.global_passes(2048, batch=2048) == [(10, 1, 32)]
    assert gpu_ntt.global_passes(2048) == [(10, 1, 4)]       # one transform: narrower CTAs
    for n1, batch in ((256, 128), (128, 256)):
        dom = NTTDomain(n1, "cpu")
        rows = torch.from_numpy(_fr((n1, batch), n1))
        planes = rows.index_select(0, dom.bitrev).permute(2, 1, 0).reshape(16, -1).contiguous()
        want = gpu_ntt.ntt_plain(planes, dom.tw_flat, range(dom.k))
        got = gpu_ntt.ntt_local_cluster_plain(rows, dom.tw_flat, rows=True)
        assert torch.equal(got, want)
    # K3's pass at the 2^22 geometry (CTAs of 32 columns x 2 rows) on two transforms
    dom = NTTDomain(2048, "cpu")
    planes = torch.from_numpy(_fr((2, 2048), 22)).permute(2, 0, 1).reshape(16, -1).contiguous()
    local = gpu_ntt.ntt_plain(planes, dom.tw_flat, range(10))
    got = gpu_ntt.ntt_global_columns_plain(local, dom.tw_flat, passes=[(10, 1, 32)], n=2048)
    assert torch.equal(got, gpu_ntt.ntt_plain(planes, dom.tw_flat, range(11)))


def test_batched_transform_rejects_bad_shapes():
    dom = NTTDomain(8, "cpu")
    for bad in (torch.zeros((4, 3, 16), dtype=torch.int32), torch.zeros((8, 3, 15),
                                                                        dtype=torch.int32),
                torch.zeros((8,), dtype=torch.int32)):
        with pytest.raises(ValueError):
            dom.ntt(bad)
    assert dom.ntt(torch.zeros((8, 0, 16), dtype=torch.int32)).shape == (8, 0, 16)
