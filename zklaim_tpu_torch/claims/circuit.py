"""The zklaim predicate circuit.

TPU-native replacement for the reference's zklaim_gadget
(zklaim/zklaim_gadget.cpp:154-783) and zklaim_input_map (:116-148).
Semantics follow SURVEY.md §2.3 exactly:

Per payload i (N payloads total, N = 0 legal):
  - witness: 384-bit preimage (5 u64 attribute slots + 1 u64 salt),
    MSB-first byte order;
  - SHA256 compression over [preimage bits || fixed 128-bit padding]
    with the standard IV == full SHA256 of the 48-byte preimage;
  - public input bits: hash(256) || refs(512) || ops(512), where refs =
    five little-endian u64s at byte offsets 0,8,16,24,32 of a zeroed
    64-byte buffer and ops = one-hot 0x01 bytes at position `op` within
    each 8-byte slot (op order: less, less_or_eq, eq, greater_or_eq,
    greater, not_eq, noop -> bytes 0..6; reference
    zklaim_gadget.cpp:71-104);
  - all public bits of all payloads are packed LSB-first-in-chunk into
    field elements of FR_CAPACITY = 253 bits; the packed elements are
    the primary input (reference packs via
    pack_bit_vector_into_field_element_vector at :148);
  - per attribute slot k in 0..4: a 64-bit comparison of the preimage
    slot value against the public reference value produces less /
    less_or_eq flags, and op-gated constraints opsval_j * flag_j =
    opsval_j enforce the selected predicate; sum_j opsval_j == 1
    enforces one-hot ops (reference :583-698).

Deviation from the reference implementation (same semantics, fewer
rows): the SHA256 digest bit variables ARE the public hash bits (no
separate hash variables + 256 equality rows), and comparisons consume
the packed preimage-slot linear combinations directly (no intermediate
data_k variables; reference :684-688 binds them with explicit rows).

Jax-free copy of zklaim_tpu/claims/circuit.py: the code is identical and only the
imports differ (..ff.limbs is this package's numpy/torch limb module,
..ff.params is this package's copy of the constants), so the port imports without jax.
"""

from __future__ import annotations

import hashlib

from ..ff.params import FR_CAPACITY
from ..gadgets import bits as B
from ..gadgets.compare import comparison
from ..gadgets.sha256 import sha256_48byte_block_bits, sha256_compression
from ..r1cs.system import LC, ONE, ZERO, ConstraintSystem

BITS_PER_PAYLOAD = 256 + 512 + 512
NUM_SLOTS = 5

# op byte positions within an 8-byte op slot (reference set_zklaim_ops)
OP_LESS, OP_LESS_EQ, OP_EQ, OP_GREATER_EQ, OP_GREATER, OP_NOT_EQ, OP_NOOP = range(7)


def bytes_to_bits_msb(data: bytes) -> list[int]:
    out = []
    for byte in data:
        for i in range(7, -1, -1):
            out.append((byte >> i) & 1)
    return out


def u64_le_bit_lc(bits, byte_offset: int) -> LC:
    """Little-endian u64 at byte_offset from MSB-first bit LCs."""
    s = LC()
    for b in range(8):
        for i in range(8):
            s = s + bits[(byte_offset + b) * 8 + i] * (1 << (8 * b + 7 - i))
    return s


def byte_lc(bits, byte_offset: int) -> LC:
    s = LC()
    for i in range(8):
        s = s + bits[byte_offset * 8 + i] * (1 << (7 - i))
    return s


def refs_buffer(data_refs) -> bytes:
    buf = bytearray(64)
    for k, v in enumerate(data_refs):
        buf[8 * k : 8 * k + 8] = int(v).to_bytes(8, "little")
    return bytes(buf)


def ops_buffer(op_positions) -> bytes:
    """op_positions: 5 byte-positions (OP_* constants, 0..6)."""
    buf = bytearray(64)
    for k, pos in enumerate(op_positions):
        buf[8 * k + pos] = 0x01
    return bytes(buf)


def pack_bits_to_ints(bit_values) -> list[int]:
    """Public input map: bits -> field elements, LSB-first in 253-chunks."""
    out = []
    for c in range(0, len(bit_values), FR_CAPACITY):
        chunk = bit_values[c : c + FR_CAPACITY]
        out.append(sum(b << j for j, b in enumerate(chunk)))
    return out


def public_inputs_for(payloads) -> list[int]:
    """Verifier-side input map (zklaim_input_map equivalent).

    payloads: iterable of (hash32: bytes, data_refs: 5 ints,
    op_positions: 5 ints).
    """
    bits = []
    for h, refs, ops in payloads:
        bits += bytes_to_bits_msb(h)
        bits += bytes_to_bits_msb(refs_buffer(refs))
        bits += bytes_to_bits_msb(ops_buffer(ops))
    return pack_bits_to_ints(bits)


class ZKlaimCircuit:
    """Circuit for N payloads; build once per N, reuse across proofs."""

    def __init__(self, num_payloads: int):
        self.num_payloads = num_payloads
        cs = ConstraintSystem()
        n_bits = BITS_PER_PAYLOAD * num_payloads
        n_chunks = (n_bits + FR_CAPACITY - 1) // FR_CAPACITY
        packed_first = cs.alloc(n_chunks) if n_chunks else None
        self.packed_vars = [packed_first + i for i in range(n_chunks)]
        cs.mark_primary_end()

        self._payload_bit_vars = []   # (pre_first, refs_first, ops_first)
        input_bits: list[LC] = []

        for p in range(num_payloads):
            pre_bits = B.alloc_input_bits(cs, 384, f"pre{p}")
            refs_bits = B.alloc_input_bits(cs, 512, f"refs{p}")
            ops_bits = B.alloc_input_bits(cs, 512, f"ops{p}")
            self._payload_bit_vars.append(
                tuple(next(iter(lcs[0].terms)) for lcs in (pre_bits, refs_bits, ops_bits))
            )

            digest = sha256_compression(cs, sha256_48byte_block_bits(pre_bits), f"sha{p}")
            input_bits += digest + refs_bits + ops_bits

            for k in range(NUM_SLOTS):
                data_lc = u64_le_bit_lc(pre_bits, 8 * k)
                ref_lc = u64_le_bit_lc(refs_bits, 8 * k)
                less, le = comparison(cs, 64, data_lc, ref_lc, f"cmp{p}.{k}")
                ops_slot = [byte_lc(ops_bits, 8 * k + j) for j in range(7)]
                o = ops_slot
                gate = cs.constrain
                gate(o[OP_LESS], less, o[OP_LESS], f"op{p}.{k}.less")
                gate(o[OP_LESS_EQ], le, o[OP_LESS_EQ], f"op{p}.{k}.le")
                gate(o[OP_EQ], le, o[OP_EQ], f"op{p}.{k}.eq1")
                gate(o[OP_EQ], ONE - less, o[OP_EQ], f"op{p}.{k}.eq2")
                gate(o[OP_GREATER_EQ], ONE - less, o[OP_GREATER_EQ], f"op{p}.{k}.ge")
                gate(o[OP_GREATER], ONE - le, o[OP_GREATER], f"op{p}.{k}.gt")
                gate(o[OP_NOT_EQ], less + (ONE - le), o[OP_NOT_EQ], f"op{p}.{k}.ne")
                gate(o[OP_NOOP], ONE, o[OP_NOOP], f"op{p}.{k}.noop")
                total = LC()
                for j in range(7):
                    total = total + o[j]
                cs.enforce_equal(total, ONE, f"op{p}.{k}.onehot")

        # multipacking: packed primary var == LSB-first chunk value
        for c, var in enumerate(self.packed_vars):
            chunk = input_bits[c * FR_CAPACITY : (c + 1) * FR_CAPACITY]
            cs.constrain(B.pack_lc(chunk) - LC.of(var), ONE, ZERO, f"pack{c}")

            def hook(w, var=var, chunk=chunk):
                w[var] = B.pack_lc(chunk).eval(w)

            in_vars = sorted(
                {v for lc in chunk for v in lc.terms if v != 0}
            )
            cs.add_hook(hook, ("py", in_vars, [var]))

        self.cs = cs

    # -- witness ----------------------------------------------------------

    def witness(self, payload_inputs) -> list[int]:
        """Full assignment for (pre48: bytes, data_refs, op_positions) list."""
        assert len(payload_inputs) == self.num_payloads

        def init(w):
            for (pre, refs, ops), (pre_v, refs_v, ops_v) in zip(
                payload_inputs, self._payload_bit_vars
            ):
                for i, bit in enumerate(bytes_to_bits_msb(pre)):
                    w[pre_v + i] = bit
                for i, bit in enumerate(bytes_to_bits_msb(refs_buffer(refs))):
                    w[refs_v + i] = bit
                for i, bit in enumerate(bytes_to_bits_msb(ops_buffer(ops))):
                    w[ops_v + i] = bit

        return self.cs.generate_witness(init)

    def public_inputs(self, payload_inputs) -> list[int]:
        """Prover-side input map: hashes computed from the preimages."""
        return public_inputs_for(
            [
                (hashlib.sha256(pre).digest(), refs, ops)
                for pre, refs, ops in payload_inputs
            ]
        )
