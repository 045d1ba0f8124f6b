"""Distributed NTT over a mesh of ranks: the four-step (Bailey) algorithm.

Counterpart of zklaim_tpu/parallel/ntt.py on torch.distributed, with its
split and its layouts.  Factor n = n1 n2 (n1 = 2^ceil(k/2)) and view the
coefficients as a row-major (n1, n2) matrix, its columns sharded over the
S ranks of the mesh axis:

  1. n2/S length-n1 NTTs along the local columns: ONE batched
     NTTDomain.ntt (one K2 launch and one K3 launch a pass on the card);
  2. twiddle by w_n^(k1 i2): one mont_mul (K1) with the rank's columns of
     the twiddle matrix, which is built on the device (`twiddle_matrix`:
     a doubling over rows, 2 log2(n1) + log2(n2/S) K1 launches) where the
     JAX package multiplies n1 n2 Python ints on the host;
  3. ONE all_to_all: (n1, n2/S) -> (n1/S, n2).  torch's all_to_all_single
     splits and concatenates along dim 0 only: rows split into S chunks
     along dim 0 are already contiguous, and what arrives (chunk i from
     rank i: this rank's rows of rank i's columns) is permuted to the
     transposed (n2, n1/S) input of step 4 in one copy;
  4. n1/S length-n2 NTTs along the rows: one batched NTTDomain.ntt.

The result lands in TRANSPOSED order: out[k1, k2] = X_hat[k2 n1 + k1],
sharded over k1 (rows).  The inverse consumes that layout and returns
natural order with one all_to_all the other way.

`ntt_t_shard` / `intt_t_shard` are the distributed transforms on a rank's
block.  `ntt_t` / `intt_t` take the global matrix, as the JAX functions
do (every rank passes the same), run the sharded transform on the rank's
block and gather the blocks, so every rank returns the global result.
"""

from __future__ import annotations

import torch

from ..ff import montgomery as M
from ..ff.limbs import NUM_LIMBS, ints_to_limbs, to_tensor
from ..ff.montgomery import FR
from ..ff.params import R, ROOT_OF_UNITY, TWO_ADICITY
from ..ntt.radix2 import _device_powers, get_domain
from .mesh import Mesh


def _mont(v: int, device) -> torch.Tensor:
    return to_tensor(ints_to_limbs([v * (1 << 256) % R])[0], device)


def twiddle_matrix(w: int, n1: int, col0: int, cols: int, device) -> torch.Tensor:
    """(n1, cols, 16) Montgomery limbs of w^(k1 i2), k1 < n1, col0 <= i2 <
    col0 + cols, built on `device`: row 1 is the powers of w (by doubling,
    times w^col0), and rows [h, 2h) are rows [0, h) times row h = (row
    h/2)^2, one mont_mul each."""
    out = torch.empty((n1, cols, NUM_LIMBS), dtype=torch.int32, device=device)
    out[0] = _mont(1, device)
    row = M.mont_mul(FR, _device_powers(w, cols, device), _mont(pow(w, col0, R), device))
    have = 1
    while have < n1:
        take = min(have, n1 - have)
        out[have : have + take] = M.mont_mul(FR, out[:take], row)
        have += take
        if have < n1:
            row = M.mont_mul(FR, row, row)
    return out


class ShardedNTT:
    """Four-step NTT plan for size n over `mesh` (axis name `axis`)."""

    def __init__(self, mesh: Mesh, n: int, axis: str = "shards"):
        if n & (n - 1) or n < 1:
            raise ValueError("domain size must be a power of two")
        self.mesh, self.axis, self.n = mesh, axis, n
        self.S = mesh.axis_size(axis)
        k = n.bit_length() - 1
        if k > TWO_ADICITY:
            raise ValueError("domain too large for Fr two-adicity")
        k1 = (k + 1) // 2
        self.n1 = 1 << k1
        self.n2 = n >> k1
        if self.n1 % self.S or self.n2 % self.S:
            raise ValueError(f"n1={self.n1}, n2={self.n2} must divide by {self.S} shards")
        self.rows, self.cols = self.n1 // self.S, self.n2 // self.S
        self.index = mesh.shard_index(axis)
        dev = mesh.device
        self.dom1 = get_domain(self.n1, str(dev))
        self.dom2 = get_domain(self.n2, str(dev))
        omega = pow(ROOT_OF_UNITY, 1 << (TWO_ADICITY - k), R)
        col0 = self.index * self.cols
        self.tw = twiddle_matrix(omega, self.n1, col0, self.cols, dev)
        self.tw_inv = twiddle_matrix(pow(omega, R - 2, R), self.n1, col0, self.cols, dev)

    # -- the distributed transforms on a rank's block -----------------------

    def ntt_t_shard(self, x_cols: torch.Tensor) -> torch.Tensor:
        """(n1, n2/S, 16) natural-order columns of this rank -> (n1/S, n2,
        16) rows of the transposed-order result."""
        S, rows, cols = self.S, self.rows, self.cols
        y = M.mont_mul(FR, self.dom1.ntt(x_cols), self.tw)                 # columns, local
        got = self.mesh.all_to_all(y.view(S, rows, cols, NUM_LIMBS), self.axis)
        z = got.permute(0, 2, 1, 3).reshape(self.n2, rows, NUM_LIMBS)     # [i cols + c, r]
        return self.dom2.ntt(z).transpose(0, 1).contiguous()              # rows, local

    def intt_t_shard(self, z_rows: torch.Tensor) -> torch.Tensor:
        """Inverse of ntt_t_shard: (n1/S, n2, 16) transposed-order rows ->
        (n1, n2/S, 16) natural-order columns."""
        S, rows, cols = self.S, self.rows, self.cols
        y = self.dom2.intt(z_rows.transpose(0, 1))                         # (n2, n1/S): [col, r]
        got = self.mesh.all_to_all(y.view(S, cols, rows, NUM_LIMBS), self.axis)
        x = got.permute(0, 2, 1, 3).reshape(self.n1, cols, NUM_LIMBS)     # [i rows + r, c]
        return self.dom1.intt(M.mont_mul(FR, x, self.tw_inv))

    # -- global matrices ------------------------------------------------------

    def ntt_t(self, x_mat: torch.Tensor) -> torch.Tensor:
        """(n1, n2, 16) natural-order matrix -> (n1, n2, 16) transposed-order
        result, gathered on every rank."""
        i, cols = self.index, self.cols
        z = self.ntt_t_shard(x_mat[:, i * cols : (i + 1) * cols])
        return self.mesh.all_gather(z, self.axis).reshape(self.n1, self.n2, NUM_LIMBS)

    def intt_t(self, z_mat: torch.Tensor) -> torch.Tensor:
        """Inverse of ntt_t: transposed-order matrix -> natural-order matrix,
        gathered on every rank."""
        i, rows = self.index, self.rows
        x = self.intt_t_shard(z_mat[i * rows : (i + 1) * rows])
        got = self.mesh.all_gather(x, self.axis)                           # (S, n1, cols, 16)
        return got.permute(1, 0, 2, 3).reshape(self.n1, self.n2, NUM_LIMBS)

    # -- layout helpers ---------------------------------------------------------

    def to_matrix(self, flat: torch.Tensor) -> torch.Tensor:
        return flat.reshape(self.n1, self.n2, NUM_LIMBS)

    def from_transposed(self, z_mat: torch.Tensor) -> torch.Tensor:
        """Transposed-order matrix -> natural-order flat evaluations."""
        return z_mat.transpose(0, 1).reshape(self.n, NUM_LIMBS)

    def transposed_from_flat(self, flat_eval: torch.Tensor) -> torch.Tensor:
        """Natural-order flat evaluations -> transposed-order matrix."""
        return flat_eval.reshape(self.n2, self.n1, NUM_LIMBS).transpose(0, 1)
