"""Carry Groth16 state from the JAX package into this one.

The two packages have their own host classes (CurvePoint, Fq, Fq2), which
do not compare equal across packages.  `host_point` rebuilds a host point
of the JAX package -- given as its CurvePoint, read by attribute and never
by importing the class, or as plain integers -- as this package's
CurvePoint; `vk_from_host` and `proof_from_host` do so for a whole key or
proof.  `pk_from_arrays` takes a proving key with the JAX package's fields
-- host points plus projective tables as (x, y, z) tuples of array-likes
of shape (n, 16) for G1 or (n, 2, 16) for G2 -- converts the five single
points and packs each table into the (n, 48 deg) int32 rows this package's
ProvingKey holds.  `qap_from_coo` builds this package's QAP from a COO
dict that already holds the input-consistency rows (the JAX QAP's
`coo_host`).  No jax import: the arrays go through numpy.
"""

from __future__ import annotations

import numpy as np

from ..ec.hostcurve import B_G1, B_G2, CurvePoint
from ..ff.hostfield import Fq, Fq2
from ..ff.limbs import to_tensor
from .api import Proof, ProvingKey, VerifyingKey
from .qap import QAP


def host_point(deg: int, src) -> CurvePoint:
    """A G1 (deg 1) or G2 (deg 2) host point of this package.

    src: an object with .inf/.x/.y (coordinates with .v, or .c0/.c1), or
    integers -- (x, y) for G1, ((x0, x1), (y0, y1)) for G2 -- or None for
    infinity."""
    b = B_G1 if deg == 1 else B_G2
    if src is None or getattr(src, "inf", False):
        return CurvePoint.infinity(b)
    x, y = (src.x, src.y) if hasattr(src, "x") else src
    if deg == 1:
        return CurvePoint(Fq(int(getattr(x, "v", x))), Fq(int(getattr(y, "v", y))), b)
    (x0, x1), (y0, y1) = (((c.c0, c.c1) if hasattr(c, "c0") else c) for c in (x, y))
    return CurvePoint(Fq2(int(x0), int(x1)), Fq2(int(y0), int(y1)), b)


def vk_from_host(src) -> VerifyingKey:
    """A VerifyingKey of this package from one with the JAX package's fields."""
    return VerifyingKey(
        alpha_g1=host_point(1, src.alpha_g1),
        beta_g2=host_point(2, src.beta_g2),
        gamma_g2=host_point(2, src.gamma_g2),
        delta_g2=host_point(2, src.delta_g2),
        ic=[host_point(1, p) for p in src.ic],
    )


def proof_from_host(src) -> Proof:
    """A Proof of this package from one with the JAX package's fields."""
    return Proof(a=host_point(1, src.a), b=host_point(2, src.b), c=host_point(1, src.c))


def pack_rows(table) -> np.ndarray:
    """(x, y, z) array-likes with batch (n,) -> (n, 48 deg) int32 rows."""
    coords = [np.asarray(c) for c in table]
    n = coords[0].shape[0]
    return np.concatenate([c.reshape(n, -1) for c in coords], axis=1).astype(np.int32)


def pk_from_arrays(src, device) -> ProvingKey:
    """A ProvingKey of this package from one with the JAX package's fields."""
    return ProvingKey(
        num_vars=src.num_vars,
        num_primary=src.num_primary,
        m=src.m,
        alpha_g1=host_point(1, src.alpha_g1),
        beta_g1=host_point(1, src.beta_g1),
        delta_g1=host_point(1, src.delta_g1),
        beta_g2=host_point(2, src.beta_g2),
        delta_g2=host_point(2, src.delta_g2),
        **{
            name: to_tensor(pack_rows(getattr(src, name)), device)
            for name in ("a_g1", "b_g1", "b_g2", "h_g1", "l_g1")
        },
    )


def qap_from_coo(coo_host: dict, num_vars: int, num_primary: int, n_cons: int,
                 device, cs=None) -> QAP:
    """This package's QAP from a COO dict with the consistency rows."""
    return QAP(coo_host, num_vars, num_primary, n_cons, device, cs)
