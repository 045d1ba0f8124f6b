"""Port field layer (zklaim_tpu_torch.ff) against the JAX package.

Same inputs (numpy, fixed seed, with the boundary values 0, 1, p-1, p-2)
go through zklaim_tpu.ff.montgomery (jit) and the port's plain versions;
field arithmetic is integer-exact, so every comparison is exact equality.
"""

import random
import re
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from zklaim_tpu.ec.hostcurve import B_G2
from zklaim_tpu.ff import limbs as JL
from zklaim_tpu.ff import montgomery as JM
from zklaim_tpu.ntt import pallas_ntt as PN

from zklaim_tpu_torch.ff import limbs as TL
from zklaim_tpu_torch.ff import montgomery as TM

# The suite runs as several worker processes on a few cores; torch's
# intra-op threads would only contend with them.
torch.set_num_threads(1)

SPECS = [(JM.FQ, TM.FQ), (JM.FR, TM.FR)]
IDS = ["Fq", "Fr"]
N = 64


def _vals(p, seed):
    rnd = random.Random(seed)
    return [0, 1, p - 1, p - 2] + [rnd.randrange(p) for _ in range(N - 4)]


def _pair(spec, seed):
    a = JL.ints_to_limbs(_vals(spec.p, seed))
    b = JL.ints_to_limbs(list(reversed(_vals(spec.p, seed + 1))))
    return a, b


def _t(arr):
    return torch.from_numpy(np.asarray(arr).astype(np.int32))


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
@pytest.mark.parametrize("op", ["mont_mul", "add_mod", "sub_mod"])
def test_binary_ops_match_jax(specs, op):
    js, ts = specs
    a, b = _pair(js, 7)
    want = jax.jit(getattr(JM, op), static_argnums=0)(js, jnp.asarray(a), jnp.asarray(b))
    _eq(getattr(TM, op)(ts, _t(a), _t(b)), want)


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
@pytest.mark.parametrize("op", ["neg_mod", "to_mont", "from_mont", "mont_inv"])
def test_unary_ops_match_jax(specs, op):
    js, ts = specs
    a, _ = _pair(js, 11)
    want = jax.jit(getattr(JM, op), static_argnums=0)(js, jnp.asarray(a))
    _eq(getattr(TM, op)(ts, _t(a)), want)


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
def test_reduce_wide_matches_jax(specs):
    """Lazy u32 segment sums (the JAX bound: < 2^32 per limb)."""
    js, ts = specs
    rng = np.random.default_rng(3)
    lazy = rng.integers(0, 1 << 32, size=(N, 16), dtype=np.uint64).astype(np.uint32)
    lazy[0] = 0xFFFFFFFF
    want = jax.jit(JM.reduce_wide, static_argnums=0)(js, jnp.asarray(lazy))
    got = TM.reduce_wide(ts, torch.from_numpy(lazy.astype(np.int64)))
    _eq(got, want)


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
def test_reduce_wide_beyond_u32_bound(specs):
    """The port's int64 accumulator may exceed 2^32 per limb (up to 2^47)."""
    _, ts = specs
    rng = np.random.default_rng(4)
    lazy = rng.integers(0, 1 << 47, size=(N, 16), dtype=np.int64)
    vals = [sum(int(v) << (16 * i) for i, v in enumerate(row)) for row in lazy]
    got = TM.reduce_wide(ts, torch.from_numpy(lazy))
    assert TL.limbs_to_ints(got.numpy()) == [v % ts.p for v in vals]


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
def test_mont_mul_plain_against_ints_broadcast(specs):
    _, ts = specs
    xs, ys = _vals(ts.p, 21), _vals(ts.p, 22)[:8]
    a = _t(TL.ints_to_limbs(xs)).view(8, 8, 16)
    b = _t(TL.ints_to_limbs(ys)).view(8, 1, 16)
    rinv = pow(1 << 256, -1, ts.p)
    want = [xs[8 * i + j] * ys[i] * rinv % ts.p for i in range(8) for j in range(8)]
    assert TL.limbs_to_ints(TM.mont_mul_plain(ts, a, b).numpy()) == want


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
def test_k1_plain_matches_pallas_bulk_mul(specs):
    """K1's plain version against pallas_ntt.bulk_mul (interpret mode on
    CPU) on (16, 256) SoA planes."""
    js, ts = specs
    rng = random.Random(5)
    a = JL.ints_to_limbs([rng.randrange(js.p) for _ in range(256)])
    b = JL.ints_to_limbs([rng.randrange(js.p) for _ in range(256)])
    want = PN.bulk_mul(js, jnp.asarray(a.T.copy()), jnp.asarray(b.T.copy()))
    got = TM.mont_mul_plain(ts, _t(a), _t(b)).t()
    _eq(got, want)


def test_carry_and_borrow_match_jax():
    rng = np.random.default_rng(6)
    lazy = rng.integers(0, 1 << 22, size=(N, 16), dtype=np.uint64).astype(np.uint32)
    jc, jout = JL.carry_canonical(jnp.asarray(lazy))
    tc, tout = TL.carry_canonical(torch.from_numpy(lazy.astype(np.int64)))
    _eq(tc, jc)
    _eq(tout, jout)
    a = rng.integers(0, 1 << 16, size=(N, 16), dtype=np.uint32)
    b = rng.integers(0, 1 << 16, size=(N, 16), dtype=np.uint32)
    jd, jb = JL.sub_borrow(jnp.asarray(a), jnp.asarray(b))
    td, tb = TL.sub_borrow(torch.from_numpy(a.astype(np.int64)), torch.from_numpy(b.astype(np.int64)))
    _eq(td, jd)
    _eq(tb, jb)
    mask = rng.integers(0, 2, size=N).astype(bool)
    _eq(TL.select(torch.from_numpy(mask), _t(a).long(), _t(b).long()),
        JL.select(jnp.asarray(mask), jnp.asarray(a), jnp.asarray(b)))


def test_host_conversions_match_jax():
    vals = _vals(TM.FQ.p, 8) + [(1 << 256) - 1]
    np.testing.assert_array_equal(TL.ints_to_limbs(vals), JL.ints_to_limbs(vals))
    np.testing.assert_array_equal(TL.int_to_limbs(vals[5]), JL.int_to_limbs(vals[5]))
    assert TL.limbs_to_ints(TL.ints_to_limbs(vals)) == vals
    np.testing.assert_array_equal(TM.encode_ints(TM.FR, vals), JM.encode_ints(JM.FR, vals))
    enc = TM.encode_ints(TM.FR, vals)
    assert TM.decode_ints(TM.FR, enc) == JM.decode_ints(JM.FR, enc)
    with pytest.raises(ValueError):
        TL.ints_to_limbs([1 << 256])


def test_field_constants_match_cuda_header():
    """The literals of csrc/field.cuh: p and n' = -p^-1 mod 2^32 per field
    (Fq, Fr order) and 3b' of G2 in Montgomery form."""
    src = (Path(TM.__file__).parent.parent / "csrc" / "field.cuh").read_text()

    def block(name):
        body = re.search(name + r"[^=]*=\s*\{(.*?)\};", src, re.S).group(1)
        return [int(h, 16) for h in re.findall(r"0x([0-9a-f]+)u", body)]

    def w32(x):
        return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(8)]

    assert block("ZK_P") == w32(TM.FQ.p) + w32(TM.FR.p)
    assert block("ZK_NP") == [(-pow(s.p, -1, 1 << 32)) % (1 << 32) for s in (TM.FQ, TM.FR)]
    b3 = B_G2 * 3
    assert block("ZK_B3_G2") == w32(b3.c0 * (1 << 256) % TM.FQ.p) + w32(b3.c1 * (1 << 256) % TM.FQ.p)
    assert (TM.FQ.field_id, TM.FR.field_id) == (0, 1)
