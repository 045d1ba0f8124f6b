"""Issuer signatures: ECDSA over the Ed25519 curve (gcrypt-compatible).

TPU-native replacement for the reference's libgcrypt signing layer
(zklaim/zklaim_ecc.c).  The reference generates an Ed25519 ECC key
(zklaim_ecc.c:216) but signs with `(data (flags raw) (value <sha256>))`
(zklaim_ecc.c:43) WITHOUT the eddsa flag, so gcrypt runs its generic
**ECDSA** on the twisted-Edwards curve -- the sig-val token is literally
"ecdsa" (zklaim_ecc.c:121,201).  Semantics verified empirically against
the repository fixtures (tests/ed25519_{priv,pub}, randfile_sig):

  - private scalar d: plain MPI (big-endian bytes), no EdDSA seed
    hashing, no clamping; Q = d*G;
  - public key encoding: 32 bytes, EdDSA-style compressed point
    (little-endian y, sign(x) in the top bit of the last byte);
  - sign: k random in [1, L); R = k*G (Edwards affine); r = R.x mod L;
    s = k^{-1} (H + r d) mod L with H = SHA256(msg) as a big-endian
    integer (no bit truncation -- "(flags raw)");
  - wire formats: sig = r||s (2 x 32B big-endian, MSB zero-padded,
    zklaim_ecc.c:114-182); pub = q (32B); priv = q||d (64B,
    zklaim_ecc.c:312-361).

Copy of zklaim_tpu/claims/signing.py kept inside this package, which imports nothing
of the JAX package: the code is identical, and the relative imports
resolve to this package's own copies.
"""

from __future__ import annotations

import hashlib
import secrets

# Ed25519 curve: -x^2 + y^2 = 1 + d x^2 y^2 over GF(2^255 - 19)
P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493   # group order
ED_D = (-121665 * pow(121666, -1, P)) % P
G_Y = 4 * pow(5, -1, P) % P


def _recover_x(y: int, sign: int):
    x2 = (y * y - 1) * pow(ED_D * y * y + 1, -1, P) % P
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P:
        x = x * pow(2, (P - 1) // 4, P) % P
    if (x * x - x2) % P:
        return None
    if x & 1 != sign:
        x = P - x
    return x


G = (_recover_x(G_Y, 0), G_Y)
IDENTITY = (0, 1)


def _add(a, b):
    (x1, y1), (x2, y2) = a, b
    k = ED_D * x1 * x2 % P * y1 % P * y2 % P
    x3 = (x1 * y2 + x2 * y1) * pow(1 + k, -1, P) % P
    y3 = (y1 * y2 + x1 * x2) * pow(1 - k, -1, P) % P
    return (x3, y3)


def _mul(k: int, pt):
    acc = IDENTITY
    while k:
        if k & 1:
            acc = _add(acc, pt)
        pt = _add(pt, pt)
        k >>= 1
    return acc


def point_compress(pt) -> bytes:
    x, y = pt
    buf = bytearray(y.to_bytes(32, "little"))
    buf[31] |= (x & 1) << 7
    return bytes(buf)


def point_decompress(buf: bytes):
    if len(buf) != 32:
        return None
    y = int.from_bytes(buf, "little") & ((1 << 255) - 1)
    if y >= P:
        return None
    x = _recover_x(y, buf[31] >> 7)
    return None if x is None else (x, y)


# -- key handling (reference-compatible serializations) ---------------------


def keygen(rng=None) -> bytes:
    """New private key as the 64-byte q||d buffer (zklaim_pk2buf layout)."""
    rand = (rng.randrange(1, L) if rng is not None else
            secrets.randbelow(L - 1) + 1)
    q = point_compress(_mul(rand, G))
    return q + rand.to_bytes(32, "big")


def pk_to_pub(priv_buf: bytes) -> bytes:
    """q||d -> 32-byte public key buffer."""
    return priv_buf[:32]


def _digest_int(msg: bytes) -> int:
    return int.from_bytes(hashlib.sha256(msg).digest(), "big")


def sign(msg: bytes, priv_buf: bytes, rng=None) -> bytes:
    """64-byte r||s signature over SHA256(msg).

    Routed through the native C++ library when built (same math,
    bit-identical output for the same nonce; tests/test_native.py).
    """
    from ..utils import native

    while True:
        k = (rng.randrange(1, L) if rng is not None else
             secrets.randbelow(L - 1) + 1)
        if native.available():
            out = native.ecdsa_sign(msg, priv_buf, k.to_bytes(32, "big"))
            if out is not None:
                return out
            continue
        d = int.from_bytes(priv_buf[32:], "big")
        h = _digest_int(msg) % L
        r = _mul(k, G)[0] % L
        if r == 0:
            continue
        s = pow(k, -1, L) * (h + r * d) % L
        if s == 0:
            continue
        return r.to_bytes(32, "big") + s.to_bytes(32, "big")


def verify(msg: bytes, sig_buf: bytes, pub_buf: bytes) -> bool:
    """Check an r||s signature against a 32-byte compressed public key."""
    if len(sig_buf) != 64:
        return False
    from ..utils import native

    if native.available():
        return native.ecdsa_verify(msg, sig_buf, pub_buf)
    q = point_decompress(pub_buf)
    if q is None:
        return False
    r = int.from_bytes(sig_buf[:32], "big")
    s = int.from_bytes(sig_buf[32:], "big")
    if not (0 < r < L and 0 < s < L):
        return False
    h = _digest_int(msg) % L
    w = pow(s, -1, L)
    pt = _add(_mul(h * w % L, G), _mul(r * w % L, q))
    return pt[0] % L == r
