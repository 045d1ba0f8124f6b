"""The original proof-of-concept circuit: one SHA256 preimage + two
hard-coded predicates.

Equivalent of the reference's early `l_gadget` (zklaim/other/gadget.hpp,
adapted there from ebfull/lightning_circuit; SURVEY.md §2.2): prove
knowledge of a 256-bit preimage r1 with SHA256(r1) == h1 (public) such
that the first u64 slot (age) satisfies age >= 18 and the second u64
slot (salary) satisfies salary > 50000 (comparison operand order per
other/gadget.hpp:143-157: less/less_or_eq of (reference, value), with
age_less_or_eq == 1 and salary_less == 1 enforced at :232-242).

Block layout (other/gadget.hpp:13-38): r1 bits || 256-bit padding
(0x80, zeros, 64-bit length 256), standard IV — equals full SHA256 of
the 32-byte preimage.  Primary input: the 256 digest bits multipacked
into field elements (l_input_map, other/gadget.hpp:294-308).

A copy of zklaim_tpu/legacy/poc_circuit.py: its relative imports reach
the port's copies of claims/circuit, gadgets/* and r1cs/system;
tests/test_torch_hostcopies.py holds the two to each other.
"""

from __future__ import annotations

import hashlib

from ..claims.circuit import bytes_to_bits_msb, pack_bits_to_ints, u64_le_bit_lc
from ..ff.params import FR_CAPACITY
from ..gadgets import bits as B
from ..gadgets.compare import comparison
from ..gadgets.sha256 import sha256_compression
from ..r1cs.system import LC, ONE, ZERO, ConstraintSystem

AGE_REFERENCE = 18
SALARY_REFERENCE = 50000

# 256-bit message padding: 0x80, 23 zero bytes, big-endian u64 length 256
POC_PADDING_BYTES = bytes([0x80] + [0] * 23 + [0, 0, 0, 0, 0, 0, 0x01, 0x00])


class PocCircuit:
    """l_gadget equivalent over the framework's R1CS builder."""

    def __init__(self):
        cs = ConstraintSystem()
        n_chunks = (256 + FR_CAPACITY - 1) // FR_CAPACITY
        first = cs.alloc(n_chunks)
        self.packed_vars = [first + i for i in range(n_chunks)]
        cs.mark_primary_end()

        pre_bits = B.alloc_input_bits(cs, 256, "r1")
        self._pre_first = next(iter(pre_bits[0].terms))

        pad = []
        for byte in POC_PADDING_BYTES:
            for i in range(7, -1, -1):
                pad.append(LC.const((byte >> i) & 1))
        digest = sha256_compression(cs, list(pre_bits) + pad, "poc.sha")

        age = u64_le_bit_lc(pre_bits, 0)
        salary = u64_le_bit_lc(pre_bits, 8)
        # age >= 18: less_or_eq of (18, age) must be 1
        _, age_le = comparison(cs, 64, LC.const(AGE_REFERENCE), age, "poc.age")
        cs.enforce_equal(age_le, ONE, "poc.age_ge_18")
        # salary > 50000: less of (50000, salary) must be 1
        sal_less, _ = comparison(
            cs, 64, LC.const(SALARY_REFERENCE), salary, "poc.salary"
        )
        cs.enforce_equal(sal_less, ONE, "poc.salary_gt_50000")

        for c, var in enumerate(self.packed_vars):
            chunk = digest[c * FR_CAPACITY : (c + 1) * FR_CAPACITY]
            cs.constrain(B.pack_lc(chunk) - LC.of(var), ONE, ZERO, f"poc.pack{c}")

            def hook(w, var=var, chunk=chunk):
                w[var] = B.pack_lc(chunk).eval(w)

            in_vars = sorted({v for lc in chunk for v in lc.terms if v != 0})
            cs.add_hook(hook, ("py", in_vars, [var]))

        self.cs = cs

    def witness(self, preimage: bytes) -> list[int]:
        assert len(preimage) == 32

        def init(w):
            for i, bit in enumerate(bytes_to_bits_msb(preimage)):
                w[self._pre_first + i] = bit

        return self.cs.generate_witness(init)

    @staticmethod
    def public_inputs(digest: bytes) -> list[int]:
        """l_input_map equivalent: pack the 256 digest bits."""
        return pack_bits_to_ints(bytes_to_bits_msb(digest))

    @staticmethod
    def make_preimage(age: int, salary: int, tail: bytes = bytes(16)) -> bytes:
        """32-byte preimage with u64 slots [age, salary, tail...]."""
        return (
            int(age).to_bytes(8, "little")
            + int(salary).to_bytes(8, "little")
            + tail
        )

    @staticmethod
    def hash_preimage(preimage: bytes) -> bytes:
        return hashlib.sha256(preimage).digest()
