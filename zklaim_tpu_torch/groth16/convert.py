"""Carry Groth16 state from the JAX package into this one.

`pk_from_arrays` takes a proving key with the JAX package's fields -- host
CurvePoints plus projective tables as (x, y, z) tuples of array-likes of
shape (n, 16) for G1 or (n, 2, 16) for G2 -- and packs each table into the
(n, 48 deg) int32 rows this package's ProvingKey holds.  `qap_from_coo`
builds this package's QAP from a COO dict that already holds the
input-consistency rows (the JAX QAP's `coo_host`).  No jax import: the
arrays go through numpy.
"""

from __future__ import annotations

import numpy as np

from ..ff.limbs import to_tensor
from .api import ProvingKey
from .qap import QAP


def pack_rows(table) -> np.ndarray:
    """(x, y, z) array-likes with batch (n,) -> (n, 48 deg) int32 rows."""
    coords = [np.asarray(c) for c in table]
    n = coords[0].shape[0]
    return np.concatenate([c.reshape(n, -1) for c in coords], axis=1).astype(np.int32)


def pk_from_arrays(src, device="cpu") -> ProvingKey:
    """A ProvingKey of this package from one with the JAX package's fields."""
    return ProvingKey(
        num_vars=src.num_vars,
        num_primary=src.num_primary,
        m=src.m,
        alpha_g1=src.alpha_g1,
        beta_g1=src.beta_g1,
        delta_g1=src.delta_g1,
        beta_g2=src.beta_g2,
        delta_g2=src.delta_g2,
        **{
            name: to_tensor(pack_rows(getattr(src, name)), device)
            for name in ("a_g1", "b_g1", "b_g2", "h_g1", "l_g1")
        },
    )


def qap_from_coo(coo_host: dict, num_vars: int, num_primary: int, n_cons: int,
                 device="cpu", cs=None) -> QAP:
    """This package's QAP from a COO dict with the consistency rows."""
    return QAP(coo_host, num_vars, num_primary, n_cons, device, cs)
