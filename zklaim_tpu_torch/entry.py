"""The credential main path, end to end: issuer setup -> holder proofs ->
verifier checks.

run_main_path(device, num_payloads, requests, seed) builds the predicate
circuit (ZKlaimCircuit(num_payloads), or the small credential-shaped
`tiny_circuit` with tiny=True), runs the trusted setup once, then for each
request builds a payload the way claims.api.Payload does (set_attr per
slot, an 8-byte salt at pre[40:48], SHA256 of the 48-byte preimage, the
ops' byte positions), proves and verifies.  It also checks the two ways a
request must fail: a predicate the attributes do not satisfy makes
`prove` raise ValueError, and a proof checked against a wrong public
input does not verify.  All randomness comes from random.Random(seed).
"""

from __future__ import annotations

import hashlib
import random
import time

import torch

from .claims.circuit import (
    OP_EQ, OP_GREATER, OP_GREATER_EQ, OP_LESS, OP_LESS_EQ, OP_NOOP, OP_NOT_EQ,
    ZKlaimCircuit, public_inputs_for,
)
from .gadgets.compare import comparison
from .groth16.api import prove, setup, verify
from .r1cs.system import ONE, ConstraintSystem

_U64 = 1 << 64


def _tiny_system():
    """A small credential-shaped circuit (comparisons + packing, no SHA):
    4 public bounds, 4 private attributes, attr_i <= bound_i enforced."""
    cs = ConstraintSystem()
    pub = [cs.alloc_lc() for _ in range(4)]
    cs.mark_primary_end()
    attrs = [cs.alloc_lc() for _ in range(4)]
    for i, (p, a) in enumerate(zip(pub, attrs)):
        less, le = comparison(cs, 64, a, p, f"cmp{i}")
        cs.enforce_equal(le, ONE, f"le{i}")

    def witness(bounds, values):
        def init(w):
            for lc, v in zip(pub + attrs, list(bounds) + list(values)):
                w[next(iter(lc.terms))] = v
        return cs.generate_witness(init)

    return cs, witness


def tiny_circuit():
    """(cs, witness) of the small circuit with bounds 100+i, attributes 10+i
    -- the same system and witness as the JAX package's __graft_entry__."""
    cs, witness = _tiny_system()
    return cs, witness([100 + i for i in range(4)], [10 + i for i in range(4)])


class _TinyWorkload:
    def __init__(self):
        self.cs, self._witness = _tiny_system()

    def request(self, rng, satisfied: bool):
        bounds = [rng.randrange(50, 1 << 40) for _ in range(4)]
        values = [rng.randrange(0, b + 1) for b in bounds]
        if not satisfied:
            values[0] = bounds[0] + 1
        return self._witness(bounds, values), bounds


_OPS = (OP_LESS, OP_LESS_EQ, OP_EQ, OP_GREATER_EQ, OP_GREATER, OP_NOT_EQ, OP_NOOP)


def _reference_for(rng, attr: int, op: int) -> int:
    """A public reference value that makes `attr op ref` true."""
    delta = rng.randrange(1, 1 << 20)
    if op in (OP_LESS, OP_NOT_EQ):
        return attr + delta
    if op == OP_LESS_EQ:
        return attr + delta - 1
    if op == OP_EQ:
        return attr
    if op == OP_GREATER_EQ:
        return attr - delta + 1
    if op == OP_GREATER:
        return attr - delta
    return rng.randrange(_U64)                # NOOP: anything


class _CredentialWorkload:
    def __init__(self, num_payloads: int):
        self.circuit = ZKlaimCircuit(num_payloads)
        self.cs = self.circuit.cs
        self.num_payloads = num_payloads

    def _payload(self, rng, satisfied: bool):
        attrs = [rng.randrange(1 << 20, 1 << 40) for _ in range(5)]
        ops = [rng.choice(_OPS) for _ in range(5)]
        refs = [_reference_for(rng, a, op) for a, op in zip(attrs, ops)]
        if not satisfied:
            ops[0], refs[0] = OP_LESS, attrs[0]          # attr < attr is false
        pre = bytearray(48)
        for pos, a in enumerate(attrs):                   # Payload.set_attr
            pre[pos * 8 : pos * 8 + 8] = a.to_bytes(8, "little")
        pre[40:48] = rng.randrange(_U64).to_bytes(8, "little")   # hash_payload
        pre = bytes(pre)
        return pre, hashlib.sha256(pre).digest(), refs, ops

    def request(self, rng, satisfied: bool):
        payloads = [self._payload(rng, satisfied) for _ in range(self.num_payloads)]
        witness = self.circuit.witness([(pre, refs, ops) for pre, _, refs, ops in payloads])
        primary = public_inputs_for([(h, refs, ops) for _, h, refs, ops in payloads])
        return witness, primary


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_main_path(device="cpu", num_payloads: int = 1, requests: int = 3, seed: int = 0,
                  tiny: bool = False) -> dict:
    """Setup once, then `requests` proofs, each verified; plus one
    unsatisfied request and one wrong-public-input verification."""
    rng = random.Random(seed)
    t0 = time.perf_counter()
    work = _TinyWorkload() if tiny else _CredentialWorkload(num_payloads)
    circuit_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    pk, vk, qap = setup(work.cs, rng, device)
    _sync(device)
    out = {
        "device": str(device),
        "circuit": "tiny" if tiny else f"ZKlaimCircuit({num_payloads})",
        "num_vars": qap.num_vars,
        "num_constraints": qap.n_cons,
        "m": qap.m,
        "circuit_s": circuit_s,
        "setup_s": time.perf_counter() - t0,
        "prove_s": [],
        "verify_s": [],
        "verified": [],
    }
    proof = primary = None
    for _ in range(requests):
        witness, primary = work.request(rng, satisfied=True)
        t0 = time.perf_counter()
        proof = prove(pk, qap, witness, rng)
        _sync(device)
        out["prove_s"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        out["verified"].append(verify(vk, primary, proof))
        out["verify_s"].append(time.perf_counter() - t0)

    witness, _ = work.request(rng, satisfied=False)
    try:
        prove(pk, qap, witness, rng)
        out["unsatisfied_rejected"] = False
    except ValueError:
        out["unsatisfied_rejected"] = True
    if proof is not None:
        wrong = [(primary[0] + 1) % (1 << 253)] + list(primary[1:])
        out["wrong_input_rejected"] = not verify(vk, wrong, proof)
    return out
