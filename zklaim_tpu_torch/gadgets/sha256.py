"""SHA256 compression-function gadget over R1CS.

TPU-native replacement for libsnark's sha256_compression_function_gadget
+ SHA256_default_IV (used by the reference circuit at
zklaim/zklaim_gadget.cpp:476-497; semantics per SURVEY.md §2.3: one
compression application over block = 384 preimage bits || 128 fixed
padding bits equals full SHA256 of the 48-byte preimage).

Bit conventions match the reference exactly: the 512 input bit LCs and
the 256 output bit LCs are in MSB-first byte order (equivalently,
big-endian bit order of the 16/8 big-endian u32 words) -- the same
order zklaim's `memtobv` produces (reference libsnark_wrapper.cpp:65-74).

Internally a word is a little-endian list of 32 bit LCs, so rotr(k)
maps out[i] = in[(i+k) % 32] and additions mod 2^32 are `decompose` of
the summed packing LCs (35-bit split absorbs the carries of up to seven
32-bit addends).

Jax-free copy of zklaim_tpu/gadgets/sha256.py: the code is identical and only the
imports differ (..ff.limbs is this package's numpy/torch limb module,
..ff.params is this package's copy of the constants), so the port imports without jax.
"""

from __future__ import annotations

from ..r1cs.system import LC, ConstraintSystem
from .bits import bxor3, ch, decompose, maj, pack_lc

SHA256_IV = [
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
]

SHA256_K = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]

# zklaim's fixed padding for a 384-bit message (reference
# zklaim_gadget.cpp:33-36): 0x80 then zeros then the 64-bit length 384.
ZKLAIM_PADDING_BYTES = bytes([0x80] + [0] * 13 + [0x01, 0x80])


def const_word(v: int) -> list:
    """32-bit constant -> little-endian bit-LC list."""
    return [LC.const((v >> i) & 1) for i in range(32)]


def _msb_first_to_words(bits_msb: list) -> list:
    """512/256 MSB-first bit LCs -> list of words (little-endian bit lists)."""
    assert len(bits_msb) % 32 == 0
    words = []
    for t in range(len(bits_msb) // 32):
        chunk = bits_msb[32 * t : 32 * (t + 1)]  # chunk[0] is bit 31
        words.append([chunk[31 - i] for i in range(32)])
    return words


def _words_to_msb_first(words: list) -> list:
    out = []
    for w in words:
        out.extend(w[31 - i] for i in range(32))
    return out


def _rotr(w: list, k: int) -> list:
    return [w[(i + k) % 32] for i in range(32)]


def _shr(w: list, k: int) -> list:
    return [w[i + k] if i + k < 32 else LC.const(0) for i in range(32)]


def _xor3w(cs, a, b, c, note):
    return [bxor3(cs, a[i], b[i], c[i], f"{note}.{i}") for i in range(32)]


def _add_words(cs, lcs, note, extra_const: int = 0) -> list:
    """Sum packing-LCs of words (+ constant) mod 2^32 -> new word bits.

    len(lcs) + (1 if extra_const) must be <= 7 so the sum fits 35 bits.
    """
    total = LC.const(extra_const)
    for x in lcs:
        total = total + x
    nbits = 35
    bits = decompose(cs, total, nbits, note)
    return bits[:32]


def sha256_compression(cs: ConstraintSystem, block_bits_msb: list, note="sha") -> list:
    """One SHA256 compression over a 512-bit block with the standard IV.

    block_bits_msb: 512 bit LCs, MSB-first byte order.
    Returns 256 digest bit LCs, MSB-first byte order.
    """
    assert len(block_bits_msb) == 512
    w_words = _msb_first_to_words(block_bits_msb)

    # message schedule
    W = list(w_words)
    for t in range(16, 64):
        s0 = _xor3w(cs, _rotr(W[t - 15], 7), _rotr(W[t - 15], 18), _shr(W[t - 15], 3), f"{note}.s0.{t}")
        s1 = _xor3w(cs, _rotr(W[t - 2], 17), _rotr(W[t - 2], 19), _shr(W[t - 2], 10), f"{note}.s1.{t}")
        W.append(
            _add_words(
                cs,
                [pack_lc(s1), pack_lc(W[t - 7]), pack_lc(s0), pack_lc(W[t - 16])],
                f"{note}.W{t}",
            )
        )

    a, b, c, d, e, f, g, h = [const_word(v) for v in SHA256_IV]

    for t in range(64):
        S1 = _xor3w(cs, _rotr(e, 6), _rotr(e, 11), _rotr(e, 25), f"{note}.S1.{t}")
        chw = [ch(cs, e[i], f[i], g[i], f"{note}.ch.{t}.{i}") for i in range(32)]
        S0 = _xor3w(cs, _rotr(a, 2), _rotr(a, 13), _rotr(a, 22), f"{note}.S0.{t}")
        majw = [maj(cs, a[i], b[i], c[i], f"{note}.maj.{t}.{i}") for i in range(32)]

        t1_terms = [pack_lc(h), pack_lc(S1), pack_lc(chw), pack_lc(W[t])]
        t2_terms = [pack_lc(S0), pack_lc(majw)]

        new_e = _add_words(cs, [pack_lc(d)] + t1_terms, f"{note}.e.{t}", SHA256_K[t])
        new_a = _add_words(cs, t1_terms + t2_terms, f"{note}.a.{t}", SHA256_K[t])

        h, g, f, e = g, f, e, new_e
        d, c, b, a = c, b, a, new_a

    digest_words = []
    for iv, reg in zip(SHA256_IV, (a, b, c, d, e, f, g, h)):
        s = _add_words(cs, [pack_lc(reg)], f"{note}.out", iv)
        digest_words.append(s)
    return _words_to_msb_first(digest_words)


def sha256_48byte_block_bits(pre_bits_msb: list) -> list:
    """384 preimage bit LCs -> full 512-bit padded block (zklaim layout)."""
    assert len(pre_bits_msb) == 384
    pad = []
    for byte in ZKLAIM_PADDING_BYTES:
        for i in range(7, -1, -1):
            pad.append(LC.const((byte >> i) & 1))
    return list(pre_bits_msb) + pad
