"""The general traffic generator: credentials and claims drawn from a seed,
with the parameters of one traffic mix (a file under traffic/).

A credential holds `num_payloads` payloads of five attributes, each drawn
uniformly from [2^lo, 2^hi) (`attr_bits`).  A claim is one predicate per
attribute: an op drawn uniformly from `ops` (zklaim.h's zklaim_op values)
and a reference value the attribute satisfies, off the attribute by a delta
below 2^`delta_bits` where the op needs one.  The generator of
zklaim_tpu_torch/entry.py (`_CredentialWorkload`, `_claim`,
`_reference_for`) is its origin; this copy is the yardstick's.

Every stream is its own `random.Random`, seeded by a string of the seed, the
stream's name and an index, so a request's draws do not depend on how many
requests came before it, and the same seed gives the same inputs.
"""

from __future__ import annotations

import random

LESS, EQ, LESS_OR_EQ, GREATER, NOT_EQ, GREATER_OR_EQ, NOOP = 1, 2, 3, 8, 9, 10, 99
_U64 = 1 << 64


def holds(attr: int, op: int, ref: int) -> bool:
    """Whether `attr op ref` is true."""
    return {LESS: attr < ref, LESS_OR_EQ: attr <= ref, EQ: attr == ref,
            GREATER_OR_EQ: attr >= ref, GREATER: attr > ref, NOT_EQ: attr != ref,
            NOOP: True}[op]


class Traffic:
    """One traffic mix's parameters and the streams of one seed."""

    def __init__(self, params: dict, num_payloads: int, seed: int):
        self.params = params
        self.num_payloads = num_payloads
        self.seed = seed

    def rng(self, stream: str, index: int = 0) -> random.Random:
        return random.Random(f"zkbench/{self.seed}/{stream}/{index}")

    def credential(self, j: int) -> list:
        """Pool credential j: num_payloads lists of five attributes."""
        lo, hi = self.params["attr_bits"]
        rng = self.rng("credential", j)
        return [[rng.randrange(1 << lo, 1 << hi) for _ in range(5)]
                for _ in range(self.num_payloads)]

    def claim(self, stream: str, i: int, attrs: list) -> list:
        """Request i of a stream: its predicates over a credential's
        attributes, a (refs, ops) pair per payload, every predicate true."""
        rng = self.rng(f"{stream}.claim", i)
        out = []
        for values in attrs:
            ops = [rng.choice(self.params["ops"]) for _ in values]
            out.append(([self._reference(rng, a, op) for a, op in zip(values, ops)], ops))
        return out

    def _reference(self, rng: random.Random, attr: int, op: int) -> int:
        delta = rng.randrange(1, 1 << self.params["delta_bits"])
        if op in (LESS, NOT_EQ):
            return attr + delta
        if op == LESS_OR_EQ:
            return attr + delta - 1
        if op == EQ:
            return attr
        if op == GREATER_OR_EQ:
            return attr - delta + 1
        if op == GREATER:
            return attr - delta
        return rng.randrange(_U64)                      # NOOP: anything
