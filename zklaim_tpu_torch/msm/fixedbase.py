"""Fixed-base multiplication s*G via a precomputed comb table.

Counterpart of zklaim_tpu/msm/fixedbase.py: T[w][d] = d * 2^(cw) * G is
built on the host once per generator (about 8k host point adds at
c = 8), then s*G = sum_w T[w][digit_w(s)] is, per window, one row gather
plus one batched complete add (kernel K4 on CUDA).  The adds run in the
same order as the JAX package's, so the projective results match it
limb for limb.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from ..ec import curve as C
from ..ec.gpu_curve import point_add_planes
from ..ec.hostcurve import CurvePoint, g1_generator, g2_generator
from ..ff.limbs import LIMB_BITS


class FixedBaseTable:
    """Per-generator comb table as packed rows (W * 2^c, 48 deg) on `device`."""

    def __init__(self, deg: int, gen: CurvePoint, c: int, device):
        if LIMB_BITS % c:
            raise ValueError("window size must divide 16")
        self.deg, self.c, self.windows = deg, c, 256 // c
        rows = []
        base = gen
        for _ in range(self.windows):
            row = [CurvePoint.infinity(gen.b)]
            for _d in range((1 << c) - 1):
                row.append(row[-1] + base)
            rows.append(row)
            base = row[-1] + base           # base * 2^c
        f = C.ops_for(deg)
        flat = [p for row in rows for p in row]
        self.table = C.planes_to_rows(C.point_to_planes(f, C.host_points_to_proj(f, flat, device)))

    def mul(self, scalars: torch.Tensor) -> torch.Tensor:
        """(k, 16) plain int32 limbs -> (3 deg, 16, k) projective planes."""
        c, W = self.c, self.windows
        per_limb = LIMB_BITS // c
        mask = (1 << c) - 1
        k = scalars.shape[0]
        acc = C.infinity_planes(self.deg, k, scalars.device)
        for w in range(W):
            d = (scalars[:, w // per_limb].long() >> (c * (w % per_limb))) & mask
            rows = self.table.index_select(0, w * (1 << c) + d)
            acc = point_add_planes(self.deg, acc, C.rows_to_planes(rows))
        return acc


@lru_cache(maxsize=None)
def g1_table(c: int, device: str) -> FixedBaseTable:
    return FixedBaseTable(1, g1_generator(), c, device)


@lru_cache(maxsize=None)
def g2_table(c: int, device: str) -> FixedBaseTable:
    return FixedBaseTable(2, g2_generator(), c, device)


def fixed_base_mul(deg: int, scalars: torch.Tensor, c: int = 8) -> torch.Tensor:
    """s*G for every row of `scalars` (G the G1 or G2 generator):
    (k, 16) plain limbs -> (3 deg, 16, k) planes."""
    table = (g1_table if deg == 1 else g2_table)(c, str(scalars.device))
    return table.mul(scalars)
