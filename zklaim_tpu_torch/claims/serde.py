"""Durable byte formats for Groth16 keys and proofs.

Counterpart of zklaim_tpu/claims/serde.py, with the same byte layout, so
keys and proofs written by either package are read by the other:

  G1 point: 64 B  = x || y, 32-byte big-endian each; infinity = zeros.
  G2 point: 128 B = x.c0 || x.c1 || y.c0 || y.c1.
  proof  : "ZKPF" || A:G1 || B:G2 || C:G1                    (260 B)
  vk     : "ZKVK" || u32 n_ic || alpha:G1 || beta:G2 ||
           gamma:G2 || delta:G2 || ic[n_ic]:G1
  pk     : "ZKPK" || u32 num_payloads, num_vars, num_primary, m ||
           alpha:G1 beta:G1 delta:G1 beta:G2 delta:G2 ||
           a[num_vars]:G1 b1[num_vars]:G1 b2[num_vars]:G2 ||
           h[m-1]:G1 l[num_vars-num_primary-1]:G1

All integers are little-endian u32.  A pk table is this package's packed
projective rows, (n, 48 deg) int32 on the key's device; its conversion to
and from affine bytes runs there: one batched Fermat inversion of Z on the
way out, to_mont and the on-curve check of every point on the way in
(each Montgomery product is kernel K1 on a CUDA tensor), with numpy only
for the limb <-> byte shuffle.  The JAX package's power-of-two padding and
module-level jits exist to share XLA compiles and have no counterpart.

Every parse validates its group elements: coordinates must be canonical
(< q) and points must lie on the curve; G2 points parsed one at a time
(proof B, vk beta/gamma/delta, pk beta/delta) additionally get an r-order
subgroup check (G1 has cofactor 1, so on-curve == in-subgroup).  Accepting
an off-curve or wrong-subgroup proof point is a classic Groth16 soundness
break.  Malformed input raises SerdeError, which the credential API maps
to ZKLAIM_* status codes.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from .. import resolve_device
from ..ec import curve as C
from ..ec.hostcurve import B_G2, CurvePoint, g1_infinity, g1_point, g2_infinity
from ..ff import montgomery as M
from ..ff.hostfield import Fq2
from ..ff.limbs import NUM_LIMBS, to_tensor
from ..ff.params import Q, R
from ..groth16.api import Proof, ProvingKey, VerifyingKey

MAGIC_PK = b"ZKPK"
MAGIC_VK = b"ZKVK"
MAGIC_PF = b"ZKPF"


class SerdeError(ValueError):
    """Malformed serialized key/proof material."""


# -- group-element validation ----------------------------------------------

_Q_WORDS = tuple(
    int.from_bytes(Q.to_bytes(32, "big")[8 * i : 8 * i + 8], "big")
    for i in range(4)
)


def _any_coord_ge_q(raw: np.ndarray) -> bool:
    """raw: (..., 32) uint8 big-endian coordinates; True if any >= q."""
    w = np.ascontiguousarray(raw).view(">u8").reshape(-1, 4)
    ge = np.zeros(w.shape[0], dtype=bool)
    eq = np.ones(w.shape[0], dtype=bool)
    for i in range(4):
        ge |= eq & (w[:, i] > _Q_WORDS[i])
        eq &= w[:, i] == _Q_WORDS[i]
    return bool((ge | eq).any())


def _b_mont(fdeg: int) -> np.ndarray:
    if fdeg == 1:
        return M.encode_ints(M.FQ, [3])[0]
    return np.stack(
        [M.encode_ints(M.FQ, [B_G2.c0])[0], M.encode_ints(M.FQ, [B_G2.c1])[0]]
    )


def _off_curve_count(f, pts) -> int:
    """Number of batch points violating y^2 z == x^3 + b z^3.

    The projective equation holds automatically for the canonical
    infinity encoding (0, 1, 0)."""
    x, y, z = pts
    y2z = f.mul(f.mul(y, y), z)
    x3 = f.mul(f.mul(x, x), x)
    bz3 = f.mul(to_tensor(_b_mont(f.deg), x.device).expand(x.shape), f.mul(f.mul(z, z), z))
    neq = y2z != f.add(x3, bz3)
    return int(neq.flatten(1).any(-1).sum())


def _check_batch(f, pts, what: str):
    n_bad = _off_curve_count(f, pts)
    if n_bad:
        raise SerdeError(f"{what}: {n_bad} point(s) not on curve")
    return pts


# -- numpy limb <-> big-endian byte conversion ------------------------------


def limbs_to_be_bytes(limbs: np.ndarray) -> np.ndarray:
    """(..., 16) canonical limbs -> (..., 32) uint8 big-endian."""
    le = np.ascontiguousarray(np.asarray(limbs), dtype=np.uint32).astype("<u2")
    raw = le.view(np.uint8).reshape(le.shape[:-1] + (2 * NUM_LIMBS,))
    return raw[..., ::-1]


def be_bytes_to_limbs(raw: np.ndarray) -> np.ndarray:
    """(..., 32) uint8 big-endian -> (..., 16) u32 limbs."""
    le = np.ascontiguousarray(np.asarray(raw, dtype=np.uint8)[..., ::-1])
    return le.view("<u2").astype(np.uint32)


# -- point tables (packed projective rows on a device) <-> bytes -------------


def _batch_to_bytes(deg: int, rows: torch.Tensor) -> bytes:
    f = C.ops_for(deg)
    x, y, _ = C.proj_to_affine_limbs(f, C.rows_to_point(deg, rows))
    xb = limbs_to_be_bytes(x.cpu().numpy()).reshape(-1, 32 * deg)
    yb = limbs_to_be_bytes(y.cpu().numpy()).reshape(-1, 32 * deg)
    return np.concatenate([xb, yb], axis=-1).tobytes()


def g1_batch_to_bytes(rows: torch.Tensor) -> bytes:
    """(n, 48) packed projective rows -> n * 64 bytes."""
    return _batch_to_bytes(1, rows)


def g2_batch_to_bytes(rows: torch.Tensor) -> bytes:
    """(n, 96) packed projective rows -> n * 128 bytes."""
    return _batch_to_bytes(2, rows)


def _batch_from_limbs(deg: int, x, y, inf, what: str, device) -> torch.Tensor:
    """Shared deserialize tail: to the device, to Montgomery projective
    form, the on-curve check of every point, packed rows out."""
    f = C.ops_for(deg)
    pts = C.affine_limbs_to_proj(
        f, to_tensor(x, device), to_tensor(y, device), torch.from_numpy(inf).to(device)
    )
    _check_batch(f, pts, what)
    return C.point_to_rows(pts)


def g1_batch_from_bytes(raw: bytes, n: int, device) -> torch.Tensor:
    if len(raw) != 64 * n:
        raise SerdeError("truncated G1 point array")
    arr = np.frombuffer(raw, dtype=np.uint8).reshape(n, 64)
    x = be_bytes_to_limbs(arr[:, :32])
    y = be_bytes_to_limbs(arr[:, 32:])
    inf = ~np.logical_or(x.any(axis=-1), y.any(axis=-1))
    if _any_coord_ge_q(arr[~inf].reshape(-1, 32)):
        raise SerdeError("G1 coordinate out of range")
    return _batch_from_limbs(1, x, y, inf, "G1 batch", device)


def g2_batch_from_bytes(raw: bytes, n: int, device) -> torch.Tensor:
    if len(raw) != 128 * n:
        raise SerdeError("truncated G2 point array")
    arr = np.frombuffer(raw, dtype=np.uint8).reshape(n, 128)
    x = be_bytes_to_limbs(arr[:, :64].reshape(n, 2, 32))
    y = be_bytes_to_limbs(arr[:, 64:].reshape(n, 2, 32))
    inf = ~np.logical_or(x.any(axis=(-1, -2)), y.any(axis=(-1, -2)))
    if _any_coord_ge_q(arr[~inf].reshape(-1, 32)):
        raise SerdeError("G2 coordinate out of range")
    return _batch_from_limbs(2, x, y, inf, "G2 batch", device)


# -- host CurvePoint <-> bytes (single points) ------------------------------


def g1_point_to_bytes(p: CurvePoint) -> bytes:
    if p.inf:
        return bytes(64)
    return p.x.v.to_bytes(32, "big") + p.y.v.to_bytes(32, "big")


def g1_point_from_bytes(raw: bytes) -> CurvePoint:
    if len(raw) != 64:
        raise SerdeError("bad G1 point length")
    if raw == bytes(64):
        return g1_infinity()
    x = int.from_bytes(raw[:32], "big")
    y = int.from_bytes(raw[32:], "big")
    if x >= Q or y >= Q:
        raise SerdeError("G1 coordinate out of range")
    p = g1_point(x, y)
    if not p.is_on_curve():
        raise SerdeError("G1 point not on curve")
    return p


def g2_point_to_bytes(p: CurvePoint) -> bytes:
    if p.inf:
        return bytes(128)
    return b"".join(
        v.to_bytes(32, "big") for v in (p.x.c0, p.x.c1, p.y.c0, p.y.c1)
    )


def g2_point_from_bytes(raw: bytes) -> CurvePoint:
    """Parse + fully validate a G2 point: on-curve AND r-order subgroup
    (G2 has a large cofactor; a curve point outside the r-subgroup in a
    proof/vk breaks Groth16 soundness)."""
    if len(raw) != 128:
        raise SerdeError("bad G2 point length")
    if raw == bytes(128):
        return g2_infinity()
    c = [int.from_bytes(raw[i : i + 32], "big") for i in range(0, 128, 32)]
    if any(v >= Q for v in c):
        raise SerdeError("G2 coordinate out of range")
    p = CurvePoint(Fq2(c[0], c[1]), Fq2(c[2], c[3]), B_G2)
    if not p.is_on_curve():
        raise SerdeError("G2 point not on curve")
    if not p.mul_raw(R).inf:
        raise SerdeError("G2 point not in the r-order subgroup")
    return p


# -- proof ------------------------------------------------------------------


def proof_to_bytes(proof: Proof) -> bytes:
    return (
        MAGIC_PF
        + g1_point_to_bytes(proof.a)
        + g2_point_to_bytes(proof.b)
        + g1_point_to_bytes(proof.c)
    )


def proof_from_bytes(raw: bytes) -> Proof:
    if len(raw) != 260 or raw[:4] != MAGIC_PF:
        raise SerdeError("bad proof encoding")
    return Proof(
        a=g1_point_from_bytes(raw[4:68]),
        b=g2_point_from_bytes(raw[68:196]),
        c=g1_point_from_bytes(raw[196:260]),
    )


# -- verification key -------------------------------------------------------


def vk_to_bytes(vk: VerifyingKey) -> bytes:
    out = [MAGIC_VK, struct.pack("<I", len(vk.ic))]
    out.append(g1_point_to_bytes(vk.alpha_g1))
    out.append(g2_point_to_bytes(vk.beta_g2))
    out.append(g2_point_to_bytes(vk.gamma_g2))
    out.append(g2_point_to_bytes(vk.delta_g2))
    for p in vk.ic:
        out.append(g1_point_to_bytes(p))
    return b"".join(out)


def vk_from_bytes(raw: bytes) -> VerifyingKey:
    if len(raw) < 8 or raw[:4] != MAGIC_VK:
        raise SerdeError("bad vk encoding")
    (n_ic,) = struct.unpack_from("<I", raw, 4)
    if len(raw) != 8 + 64 + 3 * 128 + 64 * n_ic:
        raise SerdeError("bad vk length")
    o = 8
    alpha = g1_point_from_bytes(raw[o : o + 64]); o += 64
    beta = g2_point_from_bytes(raw[o : o + 128]); o += 128
    gamma = g2_point_from_bytes(raw[o : o + 128]); o += 128
    delta = g2_point_from_bytes(raw[o : o + 128]); o += 128
    ic = []
    for _ in range(n_ic):
        ic.append(g1_point_from_bytes(raw[o : o + 64])); o += 64
    return VerifyingKey(alpha_g1=alpha, beta_g2=beta, gamma_g2=gamma, delta_g2=delta, ic=ic)


# -- proving key ------------------------------------------------------------


def pk_to_bytes(pk: ProvingKey, num_payloads: int) -> bytes:
    out = [
        MAGIC_PK,
        struct.pack("<IIII", num_payloads, pk.num_vars, pk.num_primary, pk.m),
        g1_point_to_bytes(pk.alpha_g1),
        g1_point_to_bytes(pk.beta_g1),
        g1_point_to_bytes(pk.delta_g1),
        g2_point_to_bytes(pk.beta_g2),
        g2_point_to_bytes(pk.delta_g2),
        g1_batch_to_bytes(pk.a_g1),
        g1_batch_to_bytes(pk.b_g1),
        g2_batch_to_bytes(pk.b_g2),
        g1_batch_to_bytes(pk.h_g1),
        g1_batch_to_bytes(pk.l_g1),
    ]
    return b"".join(out)


def pk_dims(raw: bytes) -> tuple[int, int, int, int]:
    """(num_payloads, num_vars, num_primary, m) from a proving key's header."""
    if len(raw) < 20 or raw[:4] != MAGIC_PK:
        raise SerdeError("bad pk encoding")
    return struct.unpack_from("<IIII", raw, 4)


def pk_from_bytes(raw: bytes, device=None) -> tuple[ProvingKey, int]:
    """Parse and validate a proving key; its tables go to `device`
    (None: the card, default_device())."""
    num_payloads, num_vars, num_primary, m = pk_dims(raw)
    n_aux = num_vars - num_primary - 1
    if num_primary >= num_vars or m < 1 or n_aux < 0:
        raise SerdeError("bad pk dimensions")
    expect = (
        20 + 3 * 64 + 2 * 128
        + 64 * num_vars * 2 + 128 * num_vars
        + 64 * (m - 1) + 64 * n_aux
    )
    if len(raw) != expect:
        raise SerdeError("bad pk length")
    device = resolve_device(device)
    o = 20
    alpha = g1_point_from_bytes(raw[o : o + 64]); o += 64
    beta1 = g1_point_from_bytes(raw[o : o + 64]); o += 64
    delta1 = g1_point_from_bytes(raw[o : o + 64]); o += 64
    beta2 = g2_point_from_bytes(raw[o : o + 128]); o += 128
    delta2 = g2_point_from_bytes(raw[o : o + 128]); o += 128
    a = g1_batch_from_bytes(raw[o : o + 64 * num_vars], num_vars, device); o += 64 * num_vars
    b1 = g1_batch_from_bytes(raw[o : o + 64 * num_vars], num_vars, device); o += 64 * num_vars
    b2 = g2_batch_from_bytes(raw[o : o + 128 * num_vars], num_vars, device); o += 128 * num_vars
    h = g1_batch_from_bytes(raw[o : o + 64 * (m - 1)], m - 1, device); o += 64 * (m - 1)
    l = g1_batch_from_bytes(raw[o : o + 64 * n_aux], n_aux, device); o += 64 * n_aux
    pk = ProvingKey(
        num_vars=num_vars, num_primary=num_primary, m=m,
        alpha_g1=alpha, beta_g1=beta1, delta_g1=delta1,
        beta_g2=beta2, delta_g2=delta2,
        a_g1=a, b_g1=b1, b_g2=b2, h_g1=h, l_g1=l,
    )
    return pk, num_payloads
