"""Lamport-Diffie one-time signatures over 256-bit messages.

Equivalent of the reference's post-quantum signature experiment
(zklaim/other/lamport.{h,c}; SURVEY.md §2.2): the private key is
2x256 random 32-byte preimages, the public key their SHA256 hashes,
a signature reveals one preimage per message bit (MSB-first within
each byte), and verification re-hashes each revealed preimage and
compares it against the matching public-key element.

Layouts match the reference byte-for-byte so keys/signatures are
interchangeable:
  privkey/pubkey: 2*256 elements of 32 bytes, element pair for bit i
    stored consecutively at offset i*64 (zero-branch first);
  sig: 256 elements of 32 bytes, one per message bit.

Copied verbatim from zklaim_tpu/legacy/lamport.py (host code, no device
work); tests/test_torch_hostcopies.py holds the two to each other.
"""

from __future__ import annotations

import hashlib
import os

MSG_BITS = 256
ELEM = MSG_BITS // 8          # 32 bytes per element
KEY_SIZE = 2 * MSG_BITS * ELEM  # 16384
SIG_SIZE = MSG_BITS * ELEM      # 8192


def create_private_key(rng=None) -> tuple[bytes, bytes]:
    """Returns (privkey, pubkey), both KEY_SIZE bytes.

    Mirrors reference create_private_key (other/lamport.c:9-28): the
    private key is raw randomness; the public key hashes each 32-byte
    element in place.
    """
    if rng is None:
        priv = os.urandom(KEY_SIZE)
    else:
        priv = bytes(rng.randrange(256) for _ in range(KEY_SIZE))
    pub = b"".join(
        hashlib.sha256(priv[i * ELEM : (i + 1) * ELEM]).digest()
        for i in range(2 * MSG_BITS)
    )
    return priv, pub


def _bit(msg: bytes, i: int) -> int:
    """Bit i of the message, MSB-first within each byte (other/lamport.c:38-44)."""
    return (msg[i // 8] >> (7 - i % 8)) & 1


def sign(msg: bytes, privkey: bytes) -> bytes:
    """Reveal privkey element (2i + bit) for each message bit i
    (other/lamport.c:30-55)."""
    assert len(msg) == ELEM and len(privkey) == KEY_SIZE
    out = bytearray(SIG_SIZE)
    for i in range(MSG_BITS):
        src = (2 * i + _bit(msg, i)) * ELEM
        out[i * ELEM : (i + 1) * ELEM] = privkey[src : src + ELEM]
    return bytes(out)


def verify(msg: bytes, pubkey: bytes, sig: bytes) -> bool:
    """Hash each revealed element, compare to the pubkey slot selected by
    the message bit (other/lamport.c:57-90).  Returns True on success."""
    if len(msg) != ELEM or len(pubkey) != KEY_SIZE or len(sig) != SIG_SIZE:
        return False
    for i in range(MSG_BITS):
        h = hashlib.sha256(sig[i * ELEM : (i + 1) * ELEM]).digest()
        ref = (2 * i + _bit(msg, i)) * ELEM
        if h != pubkey[ref : ref + ELEM]:
            return False
    return True
