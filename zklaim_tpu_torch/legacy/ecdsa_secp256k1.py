"""secp256k1 ECDSA with DER signatures and PEM/SEC1 key handling.

Equivalent of the reference's pre-gcrypt OpenSSL signing layer
(zklaim/other/zklaim_ecc.{h,c}; SURVEY.md §2.2): SHA256-digest ECDSA
sign/verify (ecdsa_sign/ecdsa_verify, other/zklaim_ecc.c:14-24,79-96),
DER signature conversion (sig_to_DER/DER_to_sig, :50-62), and EC key
loading from PEM files (load_ec_{pub,priv}_key, :26-48) -- implemented
without OpenSSL: a minimal ASN.1 DER subset covers exactly the
structures OpenSSL emits for this curve (RFC 5915 private keys, SPKI
public keys, and ECDSA-Sig-Value).

Copied verbatim from zklaim_tpu/legacy/ecdsa_secp256k1.py (host code, no
device work); tests/test_torch_hostcopies.py holds the two to each other.
"""

from __future__ import annotations

import base64
import hashlib
import secrets

# secp256k1 domain parameters
P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8

OID_EC_PUBLIC_KEY = bytes.fromhex("2a8648ce3d0201")
OID_SECP256K1 = bytes.fromhex("2b8104000a")


# -- short-Weierstrass affine arithmetic (host-side, latency-irrelevant) -----


def _add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = (3 * x1 * x1) * pow(2 * y1, -1, P) % P
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    return x3, (lam * (x1 - x3) - y1) % P


def _mul(k: int, pt):
    acc = None
    while k:
        if k & 1:
            acc = _add(acc, pt)
        pt = _add(pt, pt)
        k >>= 1
    return acc


G = (GX, GY)


# -- DER primitives -----------------------------------------------------------


def _der_len(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    body = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([0x80 | len(body)]) + body


def _der_int(v: int) -> bytes:
    body = v.to_bytes((v.bit_length() + 8) // 8 or 1, "big")
    return b"\x02" + _der_len(len(body)) + body


def _der_read(buf: bytes, off: int):
    """Parse one TLV; returns (tag, value, next_offset)."""
    tag = buf[off]
    length = buf[off + 1]
    off += 2
    if length & 0x80:
        nbytes = length & 0x7F
        length = int.from_bytes(buf[off : off + nbytes], "big")
        off += nbytes
    return tag, buf[off : off + length], off + length


def sig_to_der(r: int, s: int) -> bytes:
    """ECDSA-Sig-Value: SEQUENCE { INTEGER r, INTEGER s } (sig_to_DER)."""
    body = _der_int(r) + _der_int(s)
    return b"\x30" + _der_len(len(body)) + body


def der_to_sig(der: bytes) -> tuple[int, int] | None:
    """Inverse of sig_to_der (DER_to_sig); None on malformed input."""
    try:
        tag, body, _ = _der_read(der, 0)
        if tag != 0x30:
            return None
        tag, rb, off = _der_read(body, 0)
        if tag != 0x02:
            return None
        tag, sb, _ = _der_read(body, off)
        if tag != 0x02:
            return None
        return int.from_bytes(rb, "big"), int.from_bytes(sb, "big")
    except (IndexError, ValueError):
        return None


# -- key (de)serialization ----------------------------------------------------


def point_to_sec1(pt, compressed=False) -> bytes:
    x, y = pt
    if compressed:
        return bytes([2 + (y & 1)]) + x.to_bytes(32, "big")
    return b"\x04" + x.to_bytes(32, "big") + y.to_bytes(32, "big")


def sec1_to_point(raw: bytes):
    if raw[0] == 4 and len(raw) == 65:
        return int.from_bytes(raw[1:33], "big"), int.from_bytes(raw[33:], "big")
    if raw[0] in (2, 3) and len(raw) == 33:
        x = int.from_bytes(raw[1:], "big")
        y2 = (pow(x, 3, P) + 7) % P
        y = pow(y2, (P + 1) // 4, P)
        if y * y % P != y2:
            return None
        if y & 1 != raw[0] & 1:
            y = P - y
        return x, y
    return None


def priv_key_to_der(d: int) -> bytes:
    """RFC 5915 ECPrivateKey, as OpenSSL PEM_write_ECPrivateKey emits."""
    pub = point_to_sec1(_mul(d, G))
    inner = (
        b"\x02\x01\x01"                                    # version 1
        + b"\x04" + _der_len(32) + d.to_bytes(32, "big")    # privateKey
        + b"\xa0" + _der_len(len(OID_SECP256K1) + 2)
        + b"\x06" + _der_len(len(OID_SECP256K1)) + OID_SECP256K1
        + b"\xa1" + _der_len(len(pub) + 3)
        + b"\x03" + _der_len(len(pub) + 1) + b"\x00" + pub  # BIT STRING
    )
    return b"\x30" + _der_len(len(inner)) + inner


def pub_key_to_der(pt) -> bytes:
    """SubjectPublicKeyInfo, as OpenSSL PEM_write_EC_PUBKEY emits."""
    pub = point_to_sec1(pt)
    alg = (
        b"\x06" + _der_len(len(OID_EC_PUBLIC_KEY)) + OID_EC_PUBLIC_KEY
        + b"\x06" + _der_len(len(OID_SECP256K1)) + OID_SECP256K1
    )
    inner = (
        b"\x30" + _der_len(len(alg)) + alg
        + b"\x03" + _der_len(len(pub) + 1) + b"\x00" + pub
    )
    return b"\x30" + _der_len(len(inner)) + inner


def _pem_body(text: str, kind: str) -> bytes | None:
    begin, end = f"-----BEGIN {kind}-----", f"-----END {kind}-----"
    if begin not in text or end not in text:
        return None
    body = text.split(begin, 1)[1].split(end, 1)[0]
    return base64.b64decode("".join(body.split()))


def pem_encode(der: bytes, kind: str) -> str:
    b64 = base64.b64encode(der).decode()
    lines = [b64[i : i + 64] for i in range(0, len(b64), 64)]
    return f"-----BEGIN {kind}-----\n" + "\n".join(lines) + f"\n-----END {kind}-----\n"


def load_ec_priv_key(path: str) -> int | None:
    """Private scalar from an 'EC PRIVATE KEY' PEM file (load_ec_priv_key)."""
    der = _pem_body(open(path).read(), "EC PRIVATE KEY")
    if der is None:
        return None
    tag, body, _ = _der_read(der, 0)
    if tag != 0x30:
        return None
    _, _ver, off = _der_read(body, 0)          # version INTEGER
    tag, key, _ = _der_read(body, off)         # privateKey OCTET STRING
    if tag != 0x04:
        return None
    return int.from_bytes(key, "big")


def load_ec_pub_key(path: str):
    """Affine point from an SPKI 'PUBLIC KEY' PEM file (load_ec_pub_key)."""
    der = _pem_body(open(path).read(), "PUBLIC KEY")
    if der is None:
        return None
    tag, body, _ = _der_read(der, 0)
    if tag != 0x30:
        return None
    _, _alg, off = _der_read(body, 0)          # AlgorithmIdentifier
    tag, bits, _ = _der_read(body, off)        # BIT STRING
    if tag != 0x03 or bits[0] != 0:
        return None
    return sec1_to_point(bits[1:])


# -- sign / verify ------------------------------------------------------------


def keygen(rng=None) -> int:
    return (rng.randrange(1, N) if rng is not None else
            secrets.randbelow(N - 1) + 1)


def ecdsa_sign(data: bytes, d: int, rng=None) -> tuple[int, int]:
    """SHA256-digest ECDSA over secp256k1 (ecdsa_sign, ECDSA_do_sign)."""
    z = int.from_bytes(hashlib.sha256(data).digest(), "big")
    while True:
        k = keygen(rng)
        pt = _mul(k, G)
        r = pt[0] % N
        if r == 0:
            continue
        s = pow(k, -1, N) * (z + r * d) % N
        if s == 0:
            continue
        return r, s


def ecdsa_verify(data: bytes, sig: tuple[int, int], pub) -> bool:
    """ecdsa_verify/ECDSA_do_verify equivalent; True iff valid."""
    if pub is None or sig is None:
        return False
    r, s = sig
    if not (0 < r < N and 0 < s < N):
        return False
    z = int.from_bytes(hashlib.sha256(data).digest(), "big")
    w = pow(s, -1, N)
    pt = _add(_mul(z * w % N, G), _mul(r * w % N, pub))
    return pt is not None and pt[0] % N == r
