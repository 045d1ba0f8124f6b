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
    split = gpu_ntt.ntt_stages(planes, tw, tile=32)
    whole = gpu_ntt.ntt_stages(planes, tw, tile=n)
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
