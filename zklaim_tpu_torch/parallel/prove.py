"""Data-parallel batched Groth16 proving over a mesh of ranks.

Counterpart of zklaim_tpu/parallel/prove.py:batched_prove on
torch.distributed: k independent statements of the SAME circuit against
one proving key that every rank holds.  The batch is padded with witness 0
to a multiple of the S ranks of the mesh axis and proved in waves: in wave
w rank r takes witness w S + r, runs the witness map and its satisfaction
check, gathers every rank's flag, then -- all witnesses of the wave
satisfied -- runs the H pipeline and the five sums and gathers every rank's
sums.  Every rank then finishes every proof in input order with its own
rng (r/s blinding and single-point adds on the host), so one seed on each
rank gives the proofs of successive `prove` calls, the same on every rank.

No rank raises while the others wait in a collective: an unsatisfied
witness is known to every rank through the gathered flags, and every rank
raises ValueError("witness i unsatisfied: ...") for the first one, i < k.

`mesh=None`, or a mesh of one rank, is one device: waves of one witness,
nothing gathered.  The sums of all waves are queued before any is brought
to the host; each satisfaction check reads one flag back (a synchronisation
a witness, before that witness's sums are queued).  The JAX package pads
every table to a power of two to share XLA compiles; nothing here needs
that.
"""

from __future__ import annotations

import torch

from ..ff.params import R
from ..groth16.api import (
    ProvingKey, finish_proof, h_from_evals, prove_sums, satisfied, upload_witness,
    witness_evals,
)


def batched_prove(mesh, pk: ProvingKey, qap, witnesses: list, rng, msm_c: int = 8,
                  axis="shards") -> list:
    """Prove every witness in `witnesses` (full assignments, same circuit).

    Returns a list of Proof in input order, the same on every rank.  rng
    supplies the per-proof (r, s) blinding scalars.  Raises
    ValueError("witness i unsatisfied: ...") on every rank for the first
    witness that does not satisfy the constraints."""
    k = len(witnesses)
    if k == 0:
        return []
    shards = 1 if mesh is None else mesh.axis_size(axis)
    me = 0 if mesh is None else mesh.shard_index(axis)
    waves = -(-k // shards)
    padded = list(witnesses) + [witnesses[0]] * (waves * shards - k)

    sums = []
    for wave in range(waves):
        first = wave * shards
        w_plain = upload_witness(padded[first + me], qap.device)
        evals = witness_evals(qap, w_plain)
        ok = satisfied(evals).reshape(1).to(torch.int32)
        flags = ok if mesh is None else mesh.all_gather(ok, axis).reshape(-1)
        bad = [first + j for j, f in enumerate(flags.tolist()) if not f and first + j < k]
        if bad:
            i = bad[0]
            where = qap.cs.first_unsatisfied(witnesses[i]) if qap.cs is not None else None
            raise ValueError(f"witness {i} unsatisfied: {where}")
        part = prove_sums(pk, w_plain, h_from_evals(qap, evals), msm_c)
        if mesh is None:
            sums.append(part)
        else:
            g1, g2 = part
            sums.extend(zip(mesh.all_gather(g1, axis), mesh.all_gather(g2, axis)))

    proofs = []
    for g1, g2 in sums[:k]:
        r = rng.randrange(R)
        s = rng.randrange(R)
        proofs.append(finish_proof(pk, g1, g2, r, s))
    return proofs
