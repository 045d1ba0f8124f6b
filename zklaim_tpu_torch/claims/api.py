"""zklaim credential/claim API: payloads, contexts, wire format.

Counterpart of zklaim_tpu/claims/api.py, itself the replacement for the
reference's C credential core (zklaim/zklaim.h, zklaim/zklaim.c), with
every status code, byte layout and quirk kept.  A Context carries the
device its Groth16 work runs on: `Context(device=None)` means the card
(default_device(), resolved when the first setup or proof needs it);
deserialize passes a device on.  API and byte-level behavior mirror the
reference one-for-one:

  - error codes ZKLAIM_OK/ERROR/INVALID_SIGNATURE/INVALID_PROOF
    (zklaim.h:38-41);
  - zklaim_op enum values (zklaim.h:45-53; note greater|eq == 10 ==
    greater_or_eq);
  - payload: 5 u64 refs + 5 ops + u64 salt + SHA256 hash + priv flag +
    48-byte preimage; on-wire layout is the x86-64 C struct, 160 bytes
    including the 4-byte pad before `salt` (zklaim.h:64-71);
  - set_attr writes a little-endian u64 at pre[pos*8]; the reference's
    bound check `pos > 5` intentionally ALLOWS pos == 5 (the salt slot,
    zklaim.c:194-200 -- a documented quirk, SURVEY.md §2.5) and this
    port preserves that behavior;
  - hash_pl: salt = 8 bytes of fresh randomness copied into pre[40:48],
    hash = SHA256(pre) (zklaim.c:114-122);
  - signed view (plain_ctx): concat payload hashes || vk bytes; the
    ECDSA signature covers SHA256 of that buffer (zklaim.c:213-231);
  - context wire format: header {num_payloads, vk_size, sig_size,
    proof_size (big-endian u32), pub_key[32], sha256(header[0:48])} ||
    payloads || vk || signature[64] || proof (zklaim.c:392-436).
    The reference's header-integrity check is a no-op due to a double
    bug (compares at offset 16 with inverted logic, zklaim.c:331-335);
    this port validates the digest CORRECTLY at offset 48 and keeps the
    reference's total-length check.
"""

from __future__ import annotations

import hashlib
import os
import struct
from dataclasses import dataclass, field
from enum import IntEnum

from ..utils.profiling import count_open, span
from . import signing
from .circuit import (
    OP_EQ,
    OP_GREATER,
    OP_GREATER_EQ,
    OP_LESS,
    OP_LESS_EQ,
    OP_NOOP,
    OP_NOT_EQ,
    ZKlaimCircuit,
    public_inputs_for,
)

ZKLAIM_OK = 0
ZKLAIM_ERROR = 1
ZKLAIM_INVALID_SIGNATURE = 2
ZKLAIM_INVALID_PROOF = 3

ZKLAIM_MAX_PAYLOAD_ATTRIBUTES = 5

PAYLOAD_WIRE_SIZE = 160
HEADER_WIRE_SIZE = 80
SIGNATURE_SIZE = 64


class ZkOp(IntEnum):
    """Predicate operators with the reference's enum values."""

    LESS = 1
    LESS_OR_EQ = 3
    EQ = 2
    GREATER_OR_EQ = 10       # == GREATER | EQ, exploited at main.c:72
    GREATER = 8
    NOT_EQ = 9
    NOOP = 99


OP_TO_POSITION = {
    ZkOp.LESS: OP_LESS,
    ZkOp.LESS_OR_EQ: OP_LESS_EQ,
    ZkOp.EQ: OP_EQ,
    ZkOp.GREATER_OR_EQ: OP_GREATER_EQ,
    ZkOp.GREATER: OP_GREATER,
    ZkOp.NOT_EQ: OP_NOT_EQ,
    ZkOp.NOOP: OP_NOOP,
}


@dataclass
class Payload:
    """zklaim_payload equivalent (zklaim.h:64-71)."""

    data_ref: list = field(default_factory=lambda: [0] * 5)
    data_op: list = field(default_factory=lambda: [ZkOp.NOOP] * 5)
    salt: int = 0
    hash: bytes = bytes(32)
    priv: int = 0
    pre: bytes = bytes(48)

    def set_attr(self, attr: int, pos: int) -> int:
        """Write u64 attr at preimage slot pos.

        Mirrors zklaim_set_attr including the reference's off-by-one
        bound (pos == 5 overwrites the salt slot; zklaim.c:194-200).
        """
        if pos > 5:
            return ZKLAIM_ERROR
        pre = bytearray(self.pre)
        pre[pos * 8 : pos * 8 + 8] = int(attr).to_bytes(8, "little")
        self.pre = bytes(pre)
        return ZKLAIM_OK

    def hash_payload(self, rng=None) -> None:
        """Salt with fresh randomness and hash the preimage (zklaim_hash_pl)."""
        salt_bytes = (
            rng.randrange(1 << 64).to_bytes(8, "little")
            if rng is not None
            else os.urandom(8)
        )
        self.salt = int.from_bytes(salt_bytes, "little")
        pre = bytearray(self.pre)
        pre[40:48] = salt_bytes
        self.pre = bytes(pre)
        self.hash = hashlib.sha256(self.pre).digest()

    def clear_pre(self) -> None:
        """Blind: zero preimage + salt, set privacy flag (zklaim_clear_pres)."""
        self.pre = bytes(48)
        self.salt = 0
        self.priv = 1

    # -- C-struct wire layout (x86-64): 160 bytes -------------------------

    def to_bytes(self) -> bytes:
        buf = bytearray(PAYLOAD_WIRE_SIZE)
        for i, v in enumerate(self.data_ref):
            buf[8 * i : 8 * i + 8] = int(v).to_bytes(8, "little")
        for i, op in enumerate(self.data_op):
            buf[40 + 4 * i : 44 + 4 * i] = int(op).to_bytes(4, "little")
        # 4 bytes padding at 60..64 (u64 alignment of salt)
        buf[64:72] = int(self.salt).to_bytes(8, "little")
        buf[72:104] = self.hash
        buf[104] = self.priv
        buf[105:153] = self.pre
        # 7 bytes tail padding to 160
        return bytes(buf)

    @classmethod
    def from_bytes(cls, raw: bytes) -> "Payload":
        if len(raw) != PAYLOAD_WIRE_SIZE:
            raise ValueError("bad payload wire size")
        return cls(
            data_ref=[int.from_bytes(raw[8 * i : 8 * i + 8], "little") for i in range(5)],
            data_op=[int.from_bytes(raw[40 + 4 * i : 44 + 4 * i], "little") for i in range(5)],
            salt=int.from_bytes(raw[64:72], "little"),
            hash=raw[72:104],
            priv=raw[104],
            pre=raw[105:153],
        )

    def op_positions(self) -> list:
        return [OP_TO_POSITION[ZkOp(op)] for op in self.data_op]


class Context:
    """zklaim_ctx equivalent: payload list + key/proof buffers + signature."""

    def __init__(self, device=None):
        self.device = device
        self.payloads: list[Payload] = []
        self.pk: bytes = b""
        self.vk: bytes = b""
        self.proof: bytes = b""
        self.pub_key: bytes = bytes(32)
        self.signature: bytes = bytes(SIGNATURE_SIZE)
        self._circuit_cache = {}
        self._pk_cache = None
        self._vk_cache = None

    def __deepcopy__(self, memo):
        """Deep-copy wire state; share the immutable circuit/pk caches
        (a built ZKlaimCircuit/ProvingKey is never mutated): a copy of a
        context that has proved holds no second copy of the pk's tables on
        the card, and is the holder of a worker thread."""
        import copy as _copy

        new = Context.__new__(Context)
        new.device = self.device
        new.payloads = _copy.deepcopy(self.payloads, memo)
        new.pk, new.vk, new.proof = self.pk, self.vk, self.proof
        new.pub_key, new.signature = self.pub_key, self.signature
        new._circuit_cache = self._circuit_cache
        new._pk_cache = self._pk_cache
        new._vk_cache = getattr(self, "_vk_cache", None)
        return new

    # -- payloads ---------------------------------------------------------

    def add_payload(self, pl: Payload) -> None:
        self.payloads.append(pl)

    @property
    def num_payloads(self) -> int:
        return len(self.payloads)

    def hash_payloads(self, rng=None) -> None:
        for pl in self.payloads:
            pl.hash_payload(rng)

    def clear_pres(self) -> None:
        for pl in self.payloads:
            pl.clear_pre()

    # -- signing (issuer) -------------------------------------------------

    def _plain_view(self) -> bytes:
        """Signed view: payload hashes || vk bytes (plain_ctx, zklaim.c:213)."""
        return b"".join(pl.hash for pl in self.payloads) + self.vk

    def sign(self, priv_buf: bytes, rng=None) -> int:
        self.pub_key = signing.pk_to_pub(priv_buf)
        self.signature = signing.sign(self._plain_view(), priv_buf, rng)
        return ZKLAIM_OK

    def verify_signature(self) -> bool:
        return signing.verify(self._plain_view(), self.signature, self.pub_key)

    # -- SNARK lifecycle --------------------------------------------------

    def _circuit(self) -> ZKlaimCircuit:
        n = self.num_payloads
        if n not in self._circuit_cache:
            with span("claims.circuit"):
                self._circuit_cache[n] = ZKlaimCircuit(n)
        return self._circuit_cache[n]

    def trusted_setup(self, rng=None) -> int:
        """Groth16 setup for the current payload count (zklaim_trusted_setup);
        span claims.trusted_setup."""
        import random

        from ..groth16.api import setup
        from . import serde

        rng = rng if rng is not None else random.SystemRandom()
        with span("claims.trusted_setup"):
            circuit = self._circuit()
            with span("groth16.setup"):
                pk, vk, qap = setup(circuit.cs, rng, self.device)
            with span("serde.pk_to_bytes"):
                self.pk = serde.pk_to_bytes(pk, self.num_payloads)
            self.vk = serde.vk_to_bytes(vk)
            self._pk_cache = (self.pk, self.num_payloads, pk, qap)
            return ZKLAIM_OK

    def proof_generate(self, rng=None) -> int:
        """Prove the current payloads' predicates (zklaim_proof_generate);
        span claims.proof_generate.  The work runs on the calling thread's
        current stream and nowhere else, so holders (copies of one warm
        context) may prove at once, each on its own thread and stream;
        counter claims.in_flight: at each start, the proof_generate calls
        running in the process, this one included."""
        import random

        from .. import resolve_device
        from ..groth16.api import prove
        from ..groth16.qap import QAP
        from . import serde

        rng = rng if rng is not None else random.SystemRandom()
        with span("claims.proof_generate"):
            count_open("claims.in_flight", "claims.proof_generate")
            circuit = self._circuit()
            if (
                self._pk_cache is not None
                and self._pk_cache[0] == self.pk
                and self._pk_cache[1] == self.num_payloads
            ):
                _, _, pk, qap = self._pk_cache
            else:
                with span("claims.pk_import"):
                    device = resolve_device(self.device)
                    try:
                        pk, n_pl = serde.pk_from_bytes(self.pk, device)
                    except serde.SerdeError:
                        return ZKLAIM_ERROR
                    if n_pl != self.num_payloads:
                        return ZKLAIM_ERROR
                    qap = QAP.for_cs(circuit.cs, device)
                    self._pk_cache = (self.pk, self.num_payloads, pk, qap)
            inputs = [
                (pl.pre, pl.data_ref, pl.op_positions()) for pl in self.payloads
            ]
            try:
                with span("claims.witness"):
                    witness = circuit.witness(inputs)
                proof = prove(pk, qap, witness, rng)
            except ValueError:
                return ZKLAIM_ERROR
            with span("claims.proof_bytes"):
                self.proof = serde.proof_to_bytes(proof)
            return ZKLAIM_OK

    def proof_verify(self) -> int:
        """1 if no/invalid proof, 0 if valid (mirrors zklaim_proof_verify)."""
        from ..groth16.api import verify
        from . import serde

        if not self.proof:
            return 1
        try:
            with span("verifier.decode"):
                # vk parsing repeats per verify with identical bytes; the
                # full validation (3 G2 subgroup checks) costs ~10 ms, so
                # memoize on the raw bytes (proofs are always re-validated)
                cache = getattr(self, "_vk_cache", None)
                if cache is not None and cache[0] == self.vk:
                    vk = cache[1]
                else:
                    vk = serde.vk_from_bytes(self.vk)
                    self._vk_cache = (self.vk, vk)
                proof = serde.proof_from_bytes(self.proof)
        except serde.SerdeError:
            # malformed/off-curve material is an invalid proof, never a
            # crash (reference status-code convention, zklaim.c:354-358)
            return 1
        primary = public_inputs_for(
            [
                (pl.hash, pl.data_ref, pl.op_positions())
                for pl in self.payloads
            ]
        )
        return 0 if verify(vk, primary, proof) else 1

    def verify(self) -> int:
        """Full check: signature over (hashes || vk), then proof
        (zklaim_ctx_verify)."""
        with span("verifier.signature"):
            signed = self.verify_signature()
        if not signed:
            return ZKLAIM_INVALID_SIGNATURE
        if self.proof_verify():
            return ZKLAIM_INVALID_PROOF
        return ZKLAIM_OK

    # -- wire format (zklaim_ctx_serialize/deserialize) -------------------

    def serialize(self) -> bytes:
        header = bytearray(HEADER_WIRE_SIZE)
        struct.pack_into(
            ">IIII", header, 0,
            self.num_payloads, len(self.vk), SIGNATURE_SIZE, len(self.proof),
        )
        header[16:48] = self.pub_key
        header[48:80] = hashlib.sha256(bytes(header[:48])).digest()
        return (
            bytes(header)
            + b"".join(pl.to_bytes() for pl in self.payloads)
            + self.vk
            + self.signature
            + self.proof
        )

    @classmethod
    def deserialize(cls, raw: bytes, device=None):
        """Returns (ctx, status).  Rejects bad length or header digest."""
        if len(raw) < HEADER_WIRE_SIZE:
            return None, ZKLAIM_ERROR
        n_pl, vk_size, _sig_size, proof_size = struct.unpack_from(">IIII", raw, 0)
        if hashlib.sha256(raw[:48]).digest() != raw[48:80]:
            return None, ZKLAIM_ERROR
        total = (
            HEADER_WIRE_SIZE
            + n_pl * PAYLOAD_WIRE_SIZE
            + vk_size
            + SIGNATURE_SIZE
            + proof_size
        )
        if len(raw) != total:
            return None, ZKLAIM_ERROR
        ctx = cls(device)
        ctx.pub_key = raw[16:48]
        o = HEADER_WIRE_SIZE
        for _ in range(n_pl):
            ctx.add_payload(Payload.from_bytes(raw[o : o + PAYLOAD_WIRE_SIZE]))
            o += PAYLOAD_WIRE_SIZE
        ctx.vk = raw[o : o + vk_size]; o += vk_size
        ctx.signature = raw[o : o + SIGNATURE_SIZE]; o += SIGNATURE_SIZE
        ctx.proof = raw[o : o + proof_size]
        return ctx, ZKLAIM_OK
