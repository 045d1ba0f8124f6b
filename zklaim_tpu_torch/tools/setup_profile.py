"""Phase-level timing of the Groth16 trusted setup.

Counterpart of tools/setup_profile.py: rebuilds groth16.api.setup step by
step on the N-payload credential circuit and prints a wall-clock breakdown
-- circuit build, QAP/COO prep, host instance map (Lagrange + eval_at_tau),
scalar prep, the fixed-base comb tables (built on the host once per
process), each device fixed-base table, and the host point decode -- then
times the setup as the issuer runs it (one batched G1 call, one G2 call)
and the key's conversion to bytes.  Every mark synchronises the device.

    python -m zklaim_tpu_torch.tools.setup_profile [--payloads N] [--device cpu]
"""

from __future__ import annotations

import argparse
import random

import torch

from .. import resolve_device
from .prove_profile import Marks, format_rows


def measure(device, num_payloads: int = 1, seed: int = 42):
    """The rows main() prints: dicts with device, group, phase, ms."""
    from ..claims import serde
    from ..claims.circuit import ZKlaimCircuit
    from ..ec import curve as C
    from ..ff.params import R
    from ..groth16 import api as A
    from ..groth16.qap import QAP
    from ..msm.fixedbase import fixed_base_mul, g1_table, g2_table

    device = torch.device(device)
    m = Marks(device)
    g = "steps"
    circ = ZKlaimCircuit(num_payloads)
    cs = circ.cs
    m.mark(f"circuit build ({cs.num_constraints} cons, {cs.num_vars} vars)", g)
    qap = QAP.for_cs(cs, device)
    m.mark("QAP/COO prep", g)

    rng = random.Random(seed)
    tau = rng.randrange(1, R)
    alpha, beta, gamma, delta = (rng.randrange(1, R) for _ in range(4))
    at, bt, ct, z_tau = qap.eval_at_tau(tau)
    m.mark("instance map (eval_at_tau)", g)

    gamma_inv = pow(gamma, -1, R)
    delta_inv = pow(delta, -1, R)
    n_pub = qap.num_primary + 1
    ic_s = [(beta * at[i] + alpha * bt[i] + ct[i]) * gamma_inv % R for i in range(n_pub)]
    l_s = [(beta * at[i] + alpha * bt[i] + ct[i]) * delta_inv % R
           for i in range(n_pub, qap.num_vars)]
    h_s = []
    t_pow = 1
    for _ in range(qap.m - 1):
        h_s.append(t_pow * z_tau % R * delta_inv % R)
        t_pow = t_pow * tau % R
    m.mark("scalar prep (host)", g)

    g1_table(8, str(device))
    m.mark("comb table G1 (host build, upload)", g)
    g2_table(8, str(device))
    m.mark("comb table G2 (host build, upload)", g)

    ic_dev = None
    for name, deg, scal in [
        ("fixed_base a_g1", 1, at), ("fixed_base b_g1", 1, bt), ("fixed_base b_g2", 2, bt),
        ("fixed_base h_g1", 1, h_s), ("fixed_base l_g1", 1, l_s), ("fixed_base ic", 1, ic_s),
    ]:
        ic_dev = fixed_base_mul(deg, A._scalars(scal, device))
        m.mark(f"{name} (n={len(scal)})", g)
    C.planes_to_host_points(1, ic_dev)
    m.mark("ic host decode", g)
    m.total(g)

    g = "issuer"
    m.restart()
    pk, vk, _ = A.setup(cs, random.Random(seed), device)
    m.mark("groth16.setup (tables warm)", g)
    raw = serde.pk_to_bytes(pk, num_payloads)
    m.mark(f"pk_to_bytes ({len(raw)} B)", g)
    serde.vk_to_bytes(vk)
    m.mark("vk_to_bytes", g)
    m.total(g)
    return m.rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--payloads", type=int, default=1)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args()
    rows = measure(resolve_device(args.device), args.payloads)
    print("\n".join(format_rows(rows)), flush=True)


if __name__ == "__main__":
    main()
