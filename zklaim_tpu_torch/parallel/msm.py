"""Multi-device MSM: the point axis sharded, one point exchanged a rank.

Counterpart of zklaim_tpu/parallel/msm.py on torch.distributed.  Every rank
holds the global inputs, takes its slice of the point axis and runs the
port's local `msm` on it -- which keeps the JAX package's dispatch: a slice
of at most ZKLAIM_MSM_LADDER_MAX points goes to msm_ladder (K5 and K4), a
larger one to the flat Pippenger pipeline (K4, msm_tails, msm_finish).  The
partial results, one (3 deg, 16, 1) projective point a rank, are gathered
over the mesh axis and folded in shard order from infinity with the
complete add (gpu_curve.point_add_planes: K4 on the card), so every rank
returns the same point.  Communication is one point a rank, whatever N.

`axis` may be a tuple of axis names: the point axis is then sharded over
the flattened axes, the first one major, as the JAX package's all_gather
over a tuple stacks them.
"""

from __future__ import annotations

import torch

from ..ec import curve as C
from ..ec.gpu_curve import point_add_planes
from ..msm.pippenger import msm
from .mesh import Mesh


def sharded_msm(mesh: Mesh, deg: int, rows: torch.Tensor, scalars: torch.Tensor, c: int = 8,
                axis="shards") -> torch.Tensor:
    """sum_i scalars[i] * P_i with the point axis sharded over `mesh` ->
    (3 deg, 16, 1) projective planes, the same on every rank.

    rows: (N, 48 deg) packed projective points, scalars: (N, 16) plain Fr
    limbs, both global (every rank passes the same).  N must divide by the
    shard count: ValueError otherwise, raised before any collective."""
    shards = mesh.axis_size(axis)
    n = rows.shape[0]
    if n % shards:
        raise ValueError(f"point count {n} not divisible by {shards} shards")
    if scalars.shape[0] != n:
        raise ValueError(f"{n} points with {scalars.shape[0]} scalars")
    per = n // shards
    i = mesh.shard_index(axis)
    part = msm(deg, rows[i * per : (i + 1) * per], scalars[i * per : (i + 1) * per], c)
    parts = mesh.all_gather(part, axis)                     # (S, 3 deg, 16, 1), shard order
    acc = C.infinity_planes(deg, 1, part.device)
    for p in parts:
        acc = point_add_planes(deg, acc, p)
    return acc
