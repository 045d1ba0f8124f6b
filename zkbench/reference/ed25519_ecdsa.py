"""Verification of the issuer's signature: ECDSA over the Ed25519 curve, as
the reference's libgcrypt runs it (a raw SHA256 digest signed without the
eddsa flag), on Python integers.

Public key: 32 bytes, y little-endian with the sign of x in the top bit.
Signature: r || s, two 32-byte big-endian integers.  The signed digest is
SHA256 of the message as a big-endian integer, not truncated.

A frozen copy of the verifying half of zklaim_tpu_torch/claims/signing.py
(its pure-Python path), kept for the benchmark's plain reference.
"""

from __future__ import annotations

import hashlib

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


def point_decompress(buf: bytes):
    if len(buf) != 32:
        return None
    y = int.from_bytes(buf, "little") & ((1 << 255) - 1)
    if y >= P:
        return None
    x = _recover_x(y, buf[31] >> 7)
    return None if x is None else (x, y)


def verify(msg: bytes, sig_buf: bytes, pub_buf: bytes) -> bool:
    """Whether sig_buf is a valid r || s signature of msg under pub_buf."""
    if len(sig_buf) != 64:
        return False
    q = point_decompress(pub_buf)
    if q is None:
        return False
    r = int.from_bytes(sig_buf[:32], "big")
    s = int.from_bytes(sig_buf[32:], "big")
    if not (0 < r < L and 0 < s < L):
        return False
    h = int.from_bytes(hashlib.sha256(msg).digest(), "big") % L
    w = pow(s, -1, L)
    pt = _add(_mul(h * w % L, G), _mul(r * w % L, q))
    return pt[0] % L == r
