"""The port's byte formats (zklaim_tpu_torch.claims.serde) against the JAX
package's: the validation cases of tests/test_serde_validation.py on the
port (same inputs, same SerdeError messages), the limb <-> byte helpers
and the batch projective <-> affine conversions against the originals,
batch bytes against the single-point host codec, and pk/vk/proof round
trips.  Integer arithmetic: tolerance 0.
"""

import random

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from zklaim_tpu.claims import serde as JS
from zklaim_tpu.ec import jaxcurve as JC

from zklaim_tpu_torch.claims import serde
from zklaim_tpu_torch.claims.api import Context
from zklaim_tpu_torch.ec import curve as C
from zklaim_tpu_torch.ec.hostcurve import B_G2, CurvePoint, g1_generator, g2_generator
from zklaim_tpu_torch.ff.hostfield import Fq2
from zklaim_tpu_torch.ff.params import Q, R
from zklaim_tpu_torch.groth16.api import Proof, ProvingKey, VerifyingKey

# The suite runs as several worker processes on a few cores; torch's
# intra-op threads would only contend with them.
torch.set_num_threads(1)

GROUPS = [(1, JC.FQ_OPS, C.FQ_OPS, g1_generator), (2, JC.FQ2_OPS, C.FQ2_OPS, g2_generator)]


def _valid_proof_bytes():
    return (
        serde.MAGIC_PF
        + serde.g1_point_to_bytes(g1_generator())
        + serde.g2_point_to_bytes(g2_generator())
        + serde.g1_point_to_bytes(g1_generator() * 5)
    )


def test_valid_proof_roundtrip():
    p = serde.proof_from_bytes(_valid_proof_bytes())
    assert p.a == g1_generator()
    assert p.b == g2_generator()


def test_g1_off_curve_rejected():
    raw = (1).to_bytes(32, "big") + (1).to_bytes(32, "big")
    with pytest.raises(serde.SerdeError, match="not on curve"):
        serde.g1_point_from_bytes(raw)


def test_g1_out_of_range_rejected():
    raw = Q.to_bytes(32, "big") + (1).to_bytes(32, "big")
    with pytest.raises(serde.SerdeError, match="out of range"):
        serde.g1_point_from_bytes(raw)


def _fq2_sqrt(a: Fq2):
    """sqrt in Fq2 = Fq[u]/(u^2+1) via the norm trick (q = 3 mod 4)."""
    e = (Q + 1) // 4

    def fq_sqrt(v):
        s = pow(v, e, Q)
        return s if s * s % Q == v % Q else None

    n = (a.c0 * a.c0 + a.c1 * a.c1) % Q
    lam = fq_sqrt(n)
    if lam is None:
        return None
    for sign in (1, Q - 1):
        half = (a.c0 + sign * lam) * pow(2, -1, Q) % Q
        x0 = fq_sqrt(half)
        if x0 is None:
            continue
        x1 = a.c1 * pow(2 * x0, -1, Q) % Q
        cand = Fq2(x0, x1)
        if cand * cand == a:
            return cand
    return None


def _g2_point_outside_subgroup():
    """A point on E'(Fq2) that is (with overwhelming probability) not in
    the r-order subgroup: solve y^2 = x^3 + b' for successive x."""
    x = Fq2(1, 0)
    one = Fq2(1, 0)
    while True:
        rhs = x * x * x + B_G2
        y = _fq2_sqrt(rhs)
        if y is not None:
            p = CurvePoint(x, y, B_G2)
            assert p.is_on_curve()
            if not p.mul_raw(R).inf:
                return p
        x = x + one


def test_g2_wrong_subgroup_rejected():
    p = _g2_point_outside_subgroup()
    raw = serde.g2_point_to_bytes(p)
    with pytest.raises(serde.SerdeError, match="subgroup"):
        serde.g2_point_from_bytes(raw)
    # the batch path checks the curve only (as the original): it accepts it
    assert serde.g2_batch_from_bytes(raw, 1, "cpu").shape == (1, 96)


def test_g2_off_curve_rejected():
    raw = (1).to_bytes(32, "big") * 4
    with pytest.raises(serde.SerdeError, match="not on curve|subgroup"):
        serde.g2_point_from_bytes(raw)
    with pytest.raises(serde.SerdeError, match="G2 batch: 1 point\\(s\\) not on curve"):
        serde.g2_batch_from_bytes(serde.g2_point_to_bytes(g2_generator()) + raw, 2, "cpu")


def test_g1_batch_off_curve_rejected():
    good = serde.g1_point_to_bytes(g1_generator())
    bad = (1).to_bytes(32, "big") + (1).to_bytes(32, "big")
    with pytest.raises(serde.SerdeError, match="G1 batch: 1 point\\(s\\) not on curve"):
        serde.g1_batch_from_bytes(good + bad, 2, "cpu")
    with pytest.raises(serde.SerdeError, match="truncated G1 point array"):
        serde.g1_batch_from_bytes(good, 2, "cpu")


def test_g1_batch_out_of_range_rejected():
    bad = Q.to_bytes(32, "big") + (1).to_bytes(32, "big")
    with pytest.raises(serde.SerdeError, match="out of range"):
        serde.g1_batch_from_bytes(bad, 1, "cpu")


def test_proof_mutation_fuzz():
    """Random byte mutations of a proof: parse either succeeds or raises
    SerdeError -- never any other exception."""
    rng = random.Random(0xC0FFEE)
    base = bytearray(_valid_proof_bytes())
    for _ in range(200):
        mutated = bytearray(base)
        for _ in range(rng.randrange(1, 4)):
            mutated[rng.randrange(len(mutated))] = rng.randrange(256)
        try:
            serde.proof_from_bytes(bytes(mutated))
        except serde.SerdeError:
            pass


def test_ctx_verify_never_raises_on_garbage():
    """Context.proof_verify returns 1 (invalid) on malformed vk/proof."""
    ctx = Context("cpu")
    ctx.vk = b"garbage-vk-bytes"
    ctx.proof = b"\x00" * 260
    assert ctx.proof_verify() == 1
    ctx.proof = _valid_proof_bytes()
    assert ctx.proof_verify() == 1          # vk still garbage
    ctx.vk = serde.MAGIC_VK + b"\x01\x00\x00\x00" + b"\x00" * 100
    assert ctx.proof_verify() == 1          # truncated vk body


def test_limb_byte_helpers_match_original():
    rng = np.random.default_rng(3)
    limbs = rng.integers(0, 1 << 16, size=(5, 2, 16)).astype(np.uint32)
    raw = serde.limbs_to_be_bytes(limbs)
    np.testing.assert_array_equal(raw, JS.limbs_to_be_bytes(limbs))
    np.testing.assert_array_equal(serde.be_bytes_to_limbs(raw), JS.be_bytes_to_limbs(raw))
    np.testing.assert_array_equal(serde.be_bytes_to_limbs(raw), limbs)
    assert serde._any_coord_ge_q(np.frombuffer(Q.to_bytes(32, "big"), dtype=np.uint8)[None])
    assert not serde._any_coord_ge_q(np.frombuffer((Q - 1).to_bytes(32, "big"), dtype=np.uint8)[None])


def _host_batch(gen, seed, n=8):
    rnd = random.Random(seed)
    g = gen()
    host = [g * rnd.randrange(1, R) for _ in range(n)]
    host[1] = host[6] = g.infinity(g.b)
    return host


def _jax(pt):
    return tuple(jnp.asarray(c.numpy().astype(np.uint32)) for c in pt)


@pytest.mark.parametrize("deg,jf,tf,gen", GROUPS, ids=["G1", "G2"])
def test_affine_conversions_match_jaxcurve(deg, jf, tf, gen):
    """proj_to_affine_limbs / affine_limbs_to_proj against the JAX
    functions on 8 projective points (Z != 1), infinity included."""
    host = _host_batch(gen, 120 + deg)
    p = C.host_points_to_proj(tf, host, "cpu")
    p = C.point_double(tf, p)                            # genuinely projective
    x, y, inf = C.proj_to_affine_limbs(tf, p)
    jx, jy, jinf = JC.proj_to_affine_limbs(jf, _jax(p))
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx).astype(np.int32))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy).astype(np.int32))
    np.testing.assert_array_equal(inf.numpy(), np.asarray(jinf))
    assert inf.tolist() == [h.inf for h in host]
    back = C.affine_limbs_to_proj(tf, x, y, inf)
    want = JC.affine_limbs_to_proj(jf, jx, jy, jinf)
    for g, w in zip(back, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int32))
    assert C.proj_to_host_points(tf, back) == [h + h for h in host]


@pytest.mark.parametrize("deg,jf,tf,gen", GROUPS, ids=["G1", "G2"])
def test_batch_bytes_equal_host_codec(deg, jf, tf, gen):
    host = _host_batch(gen, 130 + deg)
    rows = C.point_to_rows(C.point_double(tf, C.host_points_to_proj(tf, host, "cpu")))
    to_bytes, from_bytes, one = (
        (serde.g1_batch_to_bytes, serde.g1_batch_from_bytes, serde.g1_point_to_bytes) if deg == 1
        else (serde.g2_batch_to_bytes, serde.g2_batch_from_bytes, serde.g2_point_to_bytes))
    raw = to_bytes(rows)
    assert raw == b"".join(one(h + h) for h in host)
    back = from_bytes(raw, len(host), "cpu")
    assert back.shape == (len(host), 48 * deg) and back.dtype == torch.int32
    assert C.proj_to_host_points(tf, C.rows_to_point(deg, back)) == [h + h for h in host]
    assert to_bytes(back) == raw
    assert torch.equal(C.point_to_rows(C.rows_to_point(deg, rows)), rows)


def _small_pk(seed):
    """A ProvingKey-shaped object with 3 variables, 1 primary, m = 4."""
    rnd = random.Random(seed)
    g1, g2 = g1_generator(), g2_generator()

    def rows(deg, n):
        f, g = C.ops_for(deg), (g1 if deg == 1 else g2)
        host = [g * rnd.randrange(1, R) for _ in range(n)]
        return C.point_to_rows(C.point_double(f, C.host_points_to_proj(f, host, "cpu")))

    return ProvingKey(
        num_vars=3, num_primary=1, m=4,
        alpha_g1=g1 * 2, beta_g1=g1 * 3, delta_g1=g1 * 4, beta_g2=g2 * 3, delta_g2=g2 * 4,
        a_g1=rows(1, 3), b_g1=rows(1, 3), b_g2=rows(2, 3), h_g1=rows(1, 3), l_g1=rows(1, 1))


def test_pk_vk_proof_roundtrip():
    g1, g2 = g1_generator(), g2_generator()
    pk = _small_pk(7)
    raw = serde.pk_to_bytes(pk, 2)
    assert len(raw) == 20 + 3 * 64 + 2 * 128 + 64 * 3 * 2 + 128 * 3 + 64 * 3 + 64 * 1
    back, n_pl = serde.pk_from_bytes(raw, "cpu")
    assert n_pl == 2 and (back.num_vars, back.num_primary, back.m) == (3, 1, 4)
    assert back.alpha_g1 == pk.alpha_g1 and back.delta_g2 == pk.delta_g2
    assert serde.pk_to_bytes(back, 2) == raw
    for name, deg in (("a_g1", 1), ("b_g1", 1), ("b_g2", 2), ("h_g1", 1), ("l_g1", 1)):
        f = C.ops_for(deg)
        assert (C.proj_to_host_points(f, C.rows_to_point(deg, getattr(back, name)))
                == C.proj_to_host_points(f, C.rows_to_point(deg, getattr(pk, name)))), name
    # one table point moved off the curve; a length that does not fit
    o = 20 + 3 * 64 + 2 * 128 + 32
    bad = raw[:o] + (int.from_bytes(raw[o : o + 32], "big") + 1).to_bytes(32, "big") + raw[o + 32 :]
    with pytest.raises(serde.SerdeError, match="G1 batch: 1 point\\(s\\) not on curve"):
        serde.pk_from_bytes(bad, "cpu")
    with pytest.raises(serde.SerdeError, match="bad pk length"):
        serde.pk_from_bytes(raw[:-1], "cpu")
    with pytest.raises(serde.SerdeError, match="bad pk encoding"):
        serde.pk_from_bytes(b"NOPE" + raw[4:], "cpu")

    vk = VerifyingKey(alpha_g1=g1 * 2, beta_g2=g2 * 3, gamma_g2=g2 * 5, delta_g2=g2 * 4,
                      ic=[g1 * 6, g1.infinity(g1.b), g1 * 7])
    vraw = serde.vk_to_bytes(vk)
    assert len(vraw) == 8 + 64 + 3 * 128 + 64 * 3
    vback = serde.vk_from_bytes(vraw)
    assert vback.ic == vk.ic and vback.gamma_g2 == vk.gamma_g2
    assert serde.vk_to_bytes(vback) == vraw
    with pytest.raises(serde.SerdeError, match="bad vk length"):
        serde.vk_from_bytes(vraw + b"\x00")

    proof = Proof(a=g1 * 9, b=g2 * 10, c=g1 * 11)
    praw = serde.proof_to_bytes(proof)
    assert len(praw) == 260 and serde.proof_from_bytes(praw) == proof


def test_pk_from_bytes_needs_a_device_or_the_card():
    """device=None means the card: without CUDA the import raises (after the
    header checks), it does not fall back to the CPU."""
    raw = serde.pk_to_bytes(_small_pk(8), 1)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        serde.pk_from_bytes(raw)
