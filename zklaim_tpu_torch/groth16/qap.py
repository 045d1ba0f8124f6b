"""R1CS -> QAP instance/witness maps for Groth16, in PyTorch.

Counterpart of zklaim_tpu/groth16/qap.py:
  - instance map (setup, host ints): Lagrange evaluations at tau and the
    per-wire sums A_i(tau), B_i(tau), C_i(tau);
  - witness map (prover): <A_j, w> per constraint as a sparse COO matvec
    on the device -- mont_mul (K1 on CUDA), an int64 index_add_ segment
    sum, one reduce_wide -- then the iNTT / coset-NTT pipeline for H.

Input-consistency rows (libsnark convention): rows n_cons + i, i =
0..num_primary, put primary wire i in A, so the domain holds
n_cons + num_primary + 1 rows.  The JAX package's power-of-two padding
of the COO exists only to share XLA compiles and is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ff import montgomery as M
from ..ff.limbs import to_tensor
from ..ff.montgomery import FR
from ..ff.params import R
from ..ntt.radix2 import NTTDomain, get_domain
from ..utils.profiling import span

# reduce_wide is exact for int64 limbs < 2^47: at most 2^31 addends per row
_MAX_ROW_NNZ = 1 << 31


def _batch_inverse(xs: list, p: int) -> list:
    """Montgomery's trick: n inversions for one pow + 3n mults."""
    n = len(xs)
    prefix = [1] * (n + 1)
    for i, x in enumerate(xs):
        prefix[i + 1] = prefix[i] * x % p
    inv_all = pow(prefix[n], p - 2, p)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv_all % p
        inv_all = inv_all * xs[i] % p
    return out


def with_consistency_rows(coo: dict, n_cons: int, num_primary: int) -> dict:
    """Append the input-consistency rows to A: row n_cons + i, wire i, 1."""
    a_rows, a_cols, a_coeffs = coo["A"]
    extra = np.arange(num_primary + 1, dtype=np.int32)
    out = dict(coo)
    out["A"] = (
        np.concatenate([a_rows, n_cons + extra]),
        np.concatenate([a_cols, extra]),
        list(a_coeffs) + [1] * (num_primary + 1),
    )
    return out


class QAP:
    """Prepared QAP artifacts for a fixed constraint system on `device`.

    `coo_host` must already hold the input-consistency rows
    (with_consistency_rows); QAP.for_cs builds it from a ConstraintSystem.
    """

    def __init__(self, coo_host: dict, num_vars: int, num_primary: int, n_cons: int,
                 device, cs=None):
        self.cs = cs
        self.device = torch.device(device)
        self.num_vars = num_vars
        self.num_primary = num_primary
        self.n_cons = n_cons
        rows_needed = n_cons + num_primary + 1
        self.m = 1 << (rows_needed - 1).bit_length()
        self.domain: NTTDomain = get_domain(self.m, str(self.device))
        self.coo_host = coo_host
        self.coo_dev = {}
        for name, (rows, cols, coeffs) in coo_host.items():
            rows = np.asarray(rows, dtype=np.int64)
            if rows.size and np.bincount(rows).max() > _MAX_ROW_NNZ:
                raise ValueError(f"{name}: a row exceeds {_MAX_ROW_NNZ} nonzeros")
            self.coo_dev[name] = (
                torch.from_numpy(rows).to(self.device),
                torch.from_numpy(np.asarray(cols, dtype=np.int64)).to(self.device),
                to_tensor(M.encode_ints(FR, coeffs), self.device),
            )

    @classmethod
    def for_cs(cls, cs, device) -> "QAP":
        """The QAP of a ConstraintSystem (span groth16.qap): its COO with
        the consistency rows, the coefficients in Montgomery form, sent."""
        with span("groth16.qap"):
            coo = with_consistency_rows(cs.to_coo(), cs.num_constraints, cs.num_primary)
            return cls(coo, cs.num_vars, cs.num_primary, cs.num_constraints, device, cs)

    # -- instance map (host, setup-time) ----------------------------------

    def lagrange_at(self, tau: int) -> list:
        """All L_j(tau), j < m: L_j = (tau^m - 1) w^j / (m (tau - w^j))."""
        m, omega = self.m, self.domain.omega
        zt = (pow(tau, m, R) - 1) % R
        if zt == 0:
            raise ValueError("tau hit the evaluation domain; resample")
        wj = [1] * m
        for j in range(1, m):
            wj[j] = wj[j - 1] * omega % R
        denoms = [m * (tau - w) % R for w in wj]
        invs = _batch_inverse(denoms, R)
        return [zt * w % R * inv % R for w, inv in zip(wj, invs)]

    def eval_at_tau(self, tau: int):
        """A_i(tau), B_i(tau), C_i(tau) for every wire i; plus Z(tau)."""
        lag = self.lagrange_at(tau)
        out = []
        for name in ("A", "B", "C"):
            acc = [0] * self.num_vars
            rows, cols, coeffs = self.coo_host[name]
            for r_, c_, v in zip(rows.tolist(), cols.tolist(), coeffs):
                acc[c_] = (acc[c_] + v * lag[r_]) % R
            out.append(acc)
        z_tau = (pow(tau, self.m, R) - 1) % R
        return out[0], out[1], out[2], z_tau

    # -- witness map (device, prover-hot) ---------------------------------

    def constraint_evals(self, w_mont: torch.Tensor):
        """<A_j,w>, <B_j,w>, <C_j,w> over the full domain: 3 x (m, 16) mont."""
        out = []
        for name in ("A", "B", "C"):
            rows, cols, coeffs = self.coo_dev[name]
            prod = M.mont_mul(FR, coeffs, w_mont.index_select(0, cols))
            lazy = torch.zeros((self.m, 16), dtype=torch.int64, device=w_mont.device)
            lazy.index_add_(0, rows, prod.long())
            out.append(M.reduce_wide(FR, lazy))
        return tuple(out)

    def h_coefficients(self, evals) -> torch.Tensor:
        """H(x) = (A(x)B(x) - C(x)) / Z(x) coefficients, (m, 16) mont.

        evals: constraint_evals(w_mont).  The last coefficient is
        identically zero (deg H = m - 2).  Spans ntt.transforms (3 intt +
        3 coset_ntt), ntt.pointwise (the quotient) and ntt.coset_intt."""
        dom = self.domain
        with span("ntt.transforms"):
            a_cos, b_cos, c_cos = (dom.coset_ntt(dom.intt(e)) for e in evals)
        with span("ntt.pointwise"):
            num = M.sub_mod(FR, M.mont_mul(FR, a_cos, b_cos), c_cos)
            quot = M.mont_mul(FR, num, dom.z_coset_inv_mont)
        with span("ntt.coset_intt"):
            return dom.coset_intt(quot)
