"""Legacy/optional capabilities of the reference (SURVEY.md §2.2), in the
port.

Counterpart of zklaim_tpu/legacy: Lamport one-time signatures, a SHA256
Merkle tree and secp256k1 ECDSA (host code, copied verbatim), the
proof-of-concept single-preimage circuit on the port's R1CS builder and
gadgets, and the object-oriented credential model on the port's
claims.api.Context.
"""
