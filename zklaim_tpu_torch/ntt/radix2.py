"""Radix-2 NTT / iNTT over BN254 Fr in PyTorch.

Counterpart of zklaim_tpu/ntt/radix2.py with the same host tables
(omega, bit reversal, per-stage twiddles, coset powers, n^{-1},
Z_H(g)^{-1}).  A transform takes AoS (n, ..., 16) Montgomery limbs and
acts along axis 0, as the JAX package's does: the B = prod(...) transforms
go through a bit-reversal index_select and one transpose to (16, B n) SoA
planes, transform b in segment b (on CUDA both inside K2's load:
gpu_ntt.ntt_local_rows), the butterfly stages of gpu_ntt (on CUDA one K2
launch and one K3 launch a pass for the whole batch), one transpose back.
The n^{-1} scale and the coset shifts are mont_mul calls (K1 on CUDA),
their tables broadcast over the batch axes.

The four tables of n powers (twiddles, inverse twiddles, coset powers and
their inverses) are built on the domain's device (`_device_powers`: log2(n)
doubling steps through mont_mul), where a host loop over n Python ints
would take minutes at n = 2^22.  They equal the JAX package's host-built
tables limb for limb.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ff import montgomery as M
from ..ff.limbs import ints_to_limbs, to_tensor
from ..ff.montgomery import FR
from ..ff.params import FR_GENERATOR, R, ROOT_OF_UNITY, TWO_ADICITY
from ..utils.device_cache import device_constant
from . import gpu_ntt


def _mont(vals) -> np.ndarray:
    return ints_to_limbs([v * (1 << 256) % R for v in vals])


def _device_powers(x: int, count: int, device) -> torch.Tensor:
    """(count, 16) Montgomery limbs of x^0 .. x^(count-1), by doubling:
    pw[2^j : 2^(j+1)] = pw[0 : 2^j] * x^(2^j), one mont_mul a step."""
    pw = torch.empty((count, 16), dtype=torch.int32, device=device)
    pw[:1] = to_tensor(_mont([1]), device)
    have = 1
    while have < count:
        step = to_tensor(_mont([pow(x, have, R)])[0], device)
        take = min(have, count - have)
        pw[have : have + take] = M.mont_mul(FR, pw[:take], step)
        have += take
    return pw


def _stage_twiddles(half_powers: torch.Tensor, k: int) -> torch.Tensor:
    """(n/2, 16) powers omega^j -> the flat (16, n - 1) twiddle planes: stage
    s holds omega^(j n / 2^(s+1)), j < 2^s, every (n / 2^(s+1))-th power."""
    half = half_powers.shape[0]
    stages = [half_powers[:: max(1, half >> s)][: 1 << s] for s in range(k)]
    return torch.cat(stages or [half_powers]).t().contiguous()     # n = 1: no stage


class NTTDomain:
    """Radix-2 evaluation domain of size n = 2^k over Fr, tables on `device`."""

    def __init__(self, n: int, device):
        if n & (n - 1) or n < 1:
            raise ValueError("domain size must be a power of two")
        k = n.bit_length() - 1
        if k > TWO_ADICITY:
            raise ValueError("domain too large for Fr two-adicity")
        self.n, self.k, self.device = n, k, torch.device(device)
        self.omega = pow(ROOT_OF_UNITY, 1 << (TWO_ADICITY - k), R)
        self.omega_inv = pow(self.omega, R - 2, R)
        self.n_inv = pow(n, R - 2, R)
        self.shift = FR_GENERATOR          # coset shift g
        self.shift_inv = pow(self.shift, R - 2, R)

        self.bitrev = gpu_ntt.bitrev_rows(n, self.device)

        # flat SoA twiddle planes: stage s (m = 2^(s+1)) holds omega_m^j,
        # j < m/2, at offset 2^s - 1
        dev = self.device
        self.tw_flat = _stage_twiddles(_device_powers(self.omega, n // 2, dev), k)     # (16, n-1)
        self.tw_inv_flat = _stage_twiddles(_device_powers(self.omega_inv, n // 2, dev), k)
        self.shift_pows = _device_powers(self.shift, n, dev)
        self.shift_pows_inv = _device_powers(self.shift_inv, n, dev)
        self.n_inv_mont = to_tensor(_mont([self.n_inv])[0], self.device)
        zg = (pow(self.shift, n, R) - 1) % R
        self.z_coset_inv_mont = to_tensor(_mont([pow(zg, R - 2, R)])[0], self.device)

    def _transform(self, x: torch.Tensor, tw_flat: torch.Tensor) -> torch.Tensor:
        if x.dim() < 2 or x.shape[0] != self.n or x.shape[-1] != 16:
            raise ValueError(f"expected ({self.n}, ..., 16) limbs, got {tuple(x.shape)}")
        if self.n == 1 or not x.numel():
            return x.clone()
        batch = x.numel() // (16 * self.n)
        planes = gpu_ntt.ntt_local_rows(x.reshape(self.n, batch, 16), tw_flat,
                                        bitrev=self.bitrev)
        planes = gpu_ntt.ntt_global(planes, tw_flat, n=self.n)
        return planes.view(16, batch, self.n).permute(2, 1, 0).contiguous().view(x.shape)

    def _bshape(self, x: torch.Tensor) -> tuple:
        """A table of n rows, broadcast over x's batch axes."""
        return (self.n,) + (1,) * (x.dim() - 2) + (16,)

    def ntt(self, x: torch.Tensor) -> torch.Tensor:
        """Coefficients -> evaluations on <omega>.  x: (n, ..., 16) mont,
        transformed along axis 0."""
        return self._transform(x, self.tw_flat)

    def intt(self, y: torch.Tensor) -> torch.Tensor:
        """Evaluations on <omega> -> coefficients."""
        return M.mont_mul(FR, self._transform(y, self.tw_inv_flat), self.n_inv_mont)

    def coset_ntt(self, x: torch.Tensor) -> torch.Tensor:
        """Coefficients -> evaluations on g<omega>."""
        return self.ntt(M.mont_mul(FR, x, self.shift_pows.view(self._bshape(x))))

    def coset_intt(self, y: torch.Tensor) -> torch.Tensor:
        """Evaluations on g<omega> -> coefficients."""
        return M.mont_mul(FR, self.intt(y), self.shift_pows_inv.view(self._bshape(y)))


@device_constant
def get_domain(n: int, device: str) -> NTTDomain:
    return NTTDomain(n, device)
