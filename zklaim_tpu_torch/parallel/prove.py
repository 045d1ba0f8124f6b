"""Batched Groth16 proving on one device.

Counterpart of zklaim_tpu/parallel/prove.py:batched_prove as bench_batched
calls it, with a mesh of one device: k independent statements of the SAME
circuit are proved against one proving key that is uploaded once, in waves
of one.  Every witness gets its own satisfaction check, which reads one flag
back from the device and so synchronises once a witness, before that
witness's MSMs are queued; the five sums of all waves are queued before any
of them is brought to the host, and only the per-proof finish (r/s blinding,
single-point adds on the host) follows.

Semantics match groth16.api.prove exactly, and so does the use of the
caller's rng: proof i draws its (r, s) in input order, so one seed gives
the same proofs as successive `prove` calls.

The JAX package pads every table to a power of two to share XLA compiles;
nothing here needs that.  The batch axis over several devices (process
groups, the sharded MSM and NTT) is not ported yet.
"""

from __future__ import annotations

from ..ff.limbs import to_tensor
from ..ff.params import R
from ..groth16.api import (
    ProvingKey, finish_proof, h_plain, prove_sums, witness_plain_limbs,
)


def batched_prove(pk: ProvingKey, qap, witnesses: list, rng, msm_c: int = 8) -> list:
    """Prove every witness in `witnesses` (full assignments, same circuit).

    Returns a list of Proof in input order.  rng supplies the per-proof
    (r, s) blinding scalars.  Raises ValueError("witness i unsatisfied: ...")
    for the first witness that does not satisfy the constraints."""
    sums = []
    for i, witness in enumerate(witnesses):
        w_plain = to_tensor(witness_plain_limbs(witness), qap.device)
        h = h_plain(qap, w_plain, witness, what=f"witness {i} unsatisfied")
        sums.append(prove_sums(pk, w_plain, h, msm_c))

    proofs = []
    for g1, g2 in sums:
        r = rng.randrange(R)
        s = rng.randrange(R)
        proofs.append(finish_proof(pk, g1, g2, r, s))
    return proofs
