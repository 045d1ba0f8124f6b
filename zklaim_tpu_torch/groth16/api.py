"""Groth16 zk-SNARK: setup / prove / verify, in PyTorch.

Counterpart of zklaim_tpu/groth16/api.py, the same proof system and the
same use of the caller's rng (setup draws tau, alpha, beta, gamma, delta;
prove draws r, s), so one seed gives the same keys and proofs in both
packages.  Work placement:
  - setup: QAP instance map on host ints, then the fixed-base comb on the
    device for the pk tables (one batched G1 call, one G2 call);
  - prove: to_mont, the sparse witness map and the NTT pipeline for H on
    the device, the satisfaction check (raises before any MSM), five
    Pippenger MSMs -- the four G1 sums as one batched msm_many, the G2
    sum alone -- launched back to back without a synchronisation between
    them, and the host finish on CurvePoints;
  - verify: the host pairing product (..ec.pairing).
The JAX package's compile-sharing workarounds (the shape-signature
h-pipeline cache, power-of-two padding of the witness and of the
fixed-base scalars) are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..ec import curve as C
from ..ec.hostcurve import CurvePoint, g1_generator, g2_generator
from ..ec.pairing import pairing_product_is_one
from ..ff import montgomery as M
from ..ff.limbs import ints_to_limbs, to_tensor
from ..ff.montgomery import FR
from ..ff.params import R
from ..msm.fixedbase import fixed_base_mul
from ..msm.pippenger import msm_many, msm_pow2
from ..utils.profiling import span
from .qap import QAP


@dataclass
class ProvingKey:
    """Host points plus device tables as packed projective rows
    (n, 48 deg) int32 -- the layout the MSM gathers from."""

    num_vars: int
    num_primary: int
    m: int
    alpha_g1: CurvePoint
    beta_g1: CurvePoint
    delta_g1: CurvePoint
    beta_g2: CurvePoint
    delta_g2: CurvePoint
    a_g1: torch.Tensor   # (num_vars, 48)
    b_g1: torch.Tensor   # (num_vars, 48)
    b_g2: torch.Tensor   # (num_vars, 96)
    h_g1: torch.Tensor   # (m-1, 48)
    l_g1: torch.Tensor   # (num_aux, 48)


@dataclass
class VerifyingKey:
    alpha_g1: CurvePoint
    beta_g2: CurvePoint
    gamma_g2: CurvePoint
    delta_g2: CurvePoint
    ic: list             # num_primary + 1 host G1 points


@dataclass
class Proof:
    a: CurvePoint
    b: CurvePoint
    c: CurvePoint


def _scalars(vals, device) -> torch.Tensor:
    return to_tensor(ints_to_limbs([v % R for v in vals]), device)


def setup(cs, rng, device=None) -> tuple[ProvingKey, VerifyingKey, QAP]:
    """Trusted setup over a finished ConstraintSystem; tables on `device`
    (None: the card, default_device()).

    rng: random.Random-like (inject a seeded one for deterministic runs).
    """
    qap = QAP.for_cs(cs, resolve_device(device))
    tau = rng.randrange(1, R)
    alpha = rng.randrange(1, R)
    beta = rng.randrange(1, R)
    gamma = rng.randrange(1, R)
    delta = rng.randrange(1, R)

    at, bt, ct, z_tau = qap.eval_at_tau(tau)
    gamma_inv = pow(gamma, -1, R)
    delta_inv = pow(delta, -1, R)

    n_pub = qap.num_primary + 1
    ic_scalars = [
        (beta * at[i] + alpha * bt[i] + ct[i]) * gamma_inv % R for i in range(n_pub)
    ]
    l_scalars = [
        (beta * at[i] + alpha * bt[i] + ct[i]) * delta_inv % R
        for i in range(n_pub, qap.num_vars)
    ]
    h_scalars = []
    t_pow = 1
    for _ in range(qap.m - 1):
        h_scalars.append(t_pow * z_tau % R * delta_inv % R)
        t_pow = t_pow * tau % R

    g1, g2 = g1_generator(), g2_generator()
    # one batched device call for every G1 table (a, b, h, l, ic)
    segs = [at, bt, h_scalars, l_scalars, ic_scalars]
    bounds = np.cumsum([0] + [len(s) for s in segs]).tolist()
    all_g1 = C.planes_to_rows(
        fixed_base_mul(1, _scalars([x for s in segs for x in s], qap.device))
    )
    a_rows, b1_rows, h_rows, l_rows, ic_rows = (
        all_g1[bounds[i] : bounds[i + 1]] for i in range(5)
    )
    pk = ProvingKey(
        num_vars=qap.num_vars,
        num_primary=qap.num_primary,
        m=qap.m,
        alpha_g1=g1 * alpha,
        beta_g1=g1 * beta,
        delta_g1=g1 * delta,
        beta_g2=g2 * beta,
        delta_g2=g2 * delta,
        a_g1=a_rows,
        b_g1=b1_rows,
        b_g2=C.planes_to_rows(fixed_base_mul(2, _scalars(bt, qap.device))),
        h_g1=h_rows,
        l_g1=l_rows,
    )
    vk = VerifyingKey(
        alpha_g1=g1 * alpha,
        beta_g2=g2 * beta,
        gamma_g2=g2 * gamma,
        delta_g2=g2 * delta,
        ic=C.planes_to_host_points(1, C.rows_to_planes(ic_rows)),
    )
    return pk, vk, qap


def witness_plain_limbs(witness) -> np.ndarray:
    """(num_vars, 16) plain-domain limbs from either witness form."""
    to_limbs = getattr(witness, "to_plain_limbs", None)
    if to_limbs is not None:
        return to_limbs()
    return ints_to_limbs(witness)


def h_plain(qap: QAP, w_plain: torch.Tensor, witness=None,
            what: str = "unsatisfied constraint") -> torch.Tensor:
    """Plain witness limbs -> plain H coefficients (m - 1, 16).

    Raises ValueError(f"{what}: <first unsatisfied constraint>") before any
    MSM if the witness does not satisfy the constraints:
    mont_mul(<A_j,w>, <B_j,w>) != <C_j,w> on some row.  Spans
    groth16.witness_map, groth16.check, then ntt.h (h_from_evals)."""
    with span("groth16.witness_map"):
        evals = witness_evals(qap, w_plain)
    with span("groth16.check"):
        ok = bool(satisfied(evals))
    if not ok:
        where = qap.cs.first_unsatisfied(witness) if qap.cs is not None else None
        raise ValueError(f"{what}: {where}")
    return h_from_evals(qap, evals)


def witness_evals(qap: QAP, w_plain: torch.Tensor):
    """The witness map: plain witness limbs -> the constraint evaluations
    (<A_j,w>, <B_j,w>, <C_j,w>) in Montgomery form."""
    return qap.constraint_evals(M.to_mont(FR, w_plain))


def satisfied(evals) -> torch.Tensor:
    """A 0-dim bool tensor on the evaluations' device: every row has
    mont_mul(<A_j,w>, <B_j,w>) == <C_j,w>."""
    a_ev, b_ev, c_ev = evals
    return (M.mont_mul(FR, a_ev, b_ev) == c_ev).all()


def h_from_evals(qap: QAP, evals) -> torch.Tensor:
    """The constraint evaluations -> plain H coefficients (m - 1, 16), in
    span ntt.h: QAP.h_coefficients' transforms and quotient, from_mont."""
    with span("ntt.h"):
        h = qap.h_coefficients(evals)
        return M.from_mont(FR, h)[: qap.m - 1]


def prove_sums(pk: ProvingKey, w_plain: torch.Tensor, h: torch.Tensor, msm_c: int = 8):
    """The prover's five Pippenger sums, launched back to back with no
    synchronisation: ((3, 16, 4) G1 planes of the A, B1, H and L sums,
    (6, 16, 1) G2 planes of the B2 sum)."""
    aux_plain = w_plain[pk.num_primary + 1 :]
    g1 = msm_many(1, [(pk.a_g1, w_plain), (pk.b_g1, w_plain), (pk.h_g1, h),
                      (pk.l_g1, aux_plain)], msm_c)
    return g1, msm_pow2(2, pk.b_g2, w_plain, msm_c)


def finish_proof(pk: ProvingKey, g1: torch.Tensor, g2: torch.Tensor, r: int, s: int) -> Proof:
    """Host finish (span groth16.finish): the five sums as CurvePoints,
    blinded by (r, s)."""
    with span("groth16.finish"):
        ev_a, ev_b1, ev_h, ev_l = C.planes_to_host_points(1, g1)
        ev_b2 = C.planes_to_host_points(2, g2)[0]

        a_pt = pk.alpha_g1 + ev_a + pk.delta_g1 * r
        b2_pt = pk.beta_g2 + ev_b2 + pk.delta_g2 * s
        b1_pt = pk.beta_g1 + ev_b1 + pk.delta_g1 * s
        c_pt = ev_l + ev_h + a_pt * s + b1_pt * r - pk.delta_g1 * (r * s % R)
        return Proof(a=a_pt, b=b2_pt, c=c_pt)


def prove(pk: ProvingKey, qap: QAP, witness, rng, msm_c: int = 8) -> Proof:
    """Groth16 prover (span groth16.prove).  witness: full assignment
    [1, primary..., aux...] (list[int] or r1cs.system.WitnessVec)."""
    with span("groth16.prove"):
        r = rng.randrange(R)
        s = rng.randrange(R)

        with span("groth16.upload"):
            w_plain = to_tensor(witness_plain_limbs(witness), qap.device)
        h = h_plain(qap, w_plain, witness)
        return finish_proof(pk, *prove_sums(pk, w_plain, h, msm_c), r, s)


def verify(vk: VerifyingKey, primary: list, proof: Proof) -> bool:
    """Strong-IC verification: primary must have exactly len(ic)-1 values.
    The public-input sum and the pairing are span verifier.pairing."""
    if len(primary) != len(vk.ic) - 1:
        return False
    with span("verifier.pairing"):
        vk_x = vk.ic[0]
        for v, pt in zip(primary, vk.ic[1:]):
            vk_x = vk_x + pt * (v % R)
        return pairing_product_is_one(
            [
                (-proof.a, proof.b),
                (vk.alpha_g1, vk.beta_g2),
                (vk_x, vk.gamma_g2),
                (proof.c, vk.delta_g2),
            ]
        )
