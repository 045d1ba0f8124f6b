"""Batched Montgomery field arithmetic over BN254 Fq / Fr in PyTorch.

Same contract as zklaim_tpu.ff.montgomery: tensors of shape (..., 16)
hold canonical base-2^16 limbs (int32 here), elements live in the
Montgomery domain (x*R mod p, R = 2^256).  Every result is the canonical
residue in [0, p), so any correct algorithm matches the JAX package limb
for limb.

`mont_mul` is the dispatcher: a CUDA tensor goes to the hand-written
kernel K1 (csrc/mont_mul.cu) for every shape -- no size threshold, so no
plain Montgomery multiply runs on the card; `mont_pow_bits` likewise sends
a CUDA tensor to ONE launch of K1's power kernel `mont_pow` (the batched
Fermat inversions of the byte formats), a CPU tensor to the binary chain
`mont_pow_bits_plain`.  A CPU tensor of `mont_mul` goes to
`mont_mul_plain`, a full-width SOS/REDC in int64 (the JAX package's
algorithm: one outer product per 256x256-bit product, anti-diagonal sums
by the pad/reshape shear).  add/sub/neg stay torch built-ins on both.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from . import params

from .limbs import (
    LIMB_BITS,
    LIMB_MASK,
    NUM_LIMBS,
    carry_canonical,
    int_to_limbs,
    ints_to_limbs,
    sub_borrow,
)

L = NUM_LIMBS


@dataclass(frozen=True)
class FieldSpec:
    """Static per-field constants (the JAX package's FieldSpec, jax-free)."""

    name: str
    p: int
    pinv16: int          # -p^{-1} mod 2^16
    r_mod: int           # R mod p       (Montgomery one)
    r2: int              # R^2 mod p     (to-Montgomery factor)
    field_id: int        # index of the field's constants in csrc/field.cuh

    p_limbs: np.ndarray = field(init=False, repr=False, compare=False)
    p_words: np.ndarray = field(init=False, repr=False, compare=False)
    one_mont: np.ndarray = field(init=False, repr=False, compare=False)
    r2_limbs: np.ndarray = field(init=False, repr=False, compare=False)
    nprime_limbs: np.ndarray = field(init=False, repr=False, compare=False)
    exp_p_minus_2_bits: np.ndarray = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "p_limbs", int_to_limbs(self.p))
        object.__setattr__(self, "p_words", np.array(
            [(self.p >> (32 * j)) & 0xFFFFFFFF for j in range(L // 2)], dtype=np.int64))
        object.__setattr__(self, "p2_limbs", int_to_limbs(2 * self.p))
        object.__setattr__(self, "p4_limbs", int_to_limbs(4 * self.p))
        object.__setattr__(self, "one_mont", int_to_limbs(self.r_mod))
        object.__setattr__(self, "r2_limbs", int_to_limbs(self.r2))
        nprime = (-pow(self.p, -1, params.MONT_R)) % params.MONT_R
        object.__setattr__(self, "nprime_limbs", int_to_limbs(nprime))
        bits = np.array([(self.p - 2 >> i) & 1 for i in range(256)], dtype=np.uint32)
        object.__setattr__(self, "exp_p_minus_2_bits", bits)
        object.__setattr__(self, "_dev", {})

    def __hash__(self):
        return hash((self.name, self.p))

    def const(self, name: str, device) -> torch.Tensor:
        """An int64 constant (limbs or words) on `device`, cached per device."""
        key = (name, str(device))
        t = self._dev.get(key)
        if t is None:
            t = self._dev[key] = torch.from_numpy(
                getattr(self, name).astype(np.int64)
            ).to(device)
        return t


FQ = FieldSpec("Fq", params.Q, params.Q_PINV16, params.Q_R_MOD, params.Q_R2, 0)
FR = FieldSpec("Fr", params.R, params.R_PINV16, params.R_R_MOD, params.R_R2, 1)


# ---------------------------------------------------------------------------
# Plain versions (int64 torch ops on limb-major views)
#
# Inside a function the limb axis is moved to the front, (16, ...), so
# every step of a carry chain and every partial product is a contiguous
# row; inputs and outputs keep the (..., 16) layout.  Carry and borrow
# chains run over 32-bit words (pairs of limbs) held in int64: half the
# steps of a 16-bit chain, and the plain versions are op-count bound at
# the small widths the CPU runs.
# ---------------------------------------------------------------------------

WORD_MASK = (1 << 32) - 1


def _lm(x: torch.Tensor) -> torch.Tensor:
    """(..., 16) limbs -> (16, ...) int64 limb-major."""
    return x.long().movedim(-1, 0).contiguous()


def _out(x: torch.Tensor) -> torch.Tensor:
    """(16, ...) int64 limb-major -> (..., 16) int32 contiguous."""
    return x.movedim(0, -1).to(torch.int32).contiguous()


def _col(spec: FieldSpec, name: str, like: torch.Tensor) -> torch.Tensor:
    """A field constant as a column (n, 1, ...) broadcasting against `like`."""
    c = spec.const(name, like.device)
    return c.view(c.shape + (1,) * (like.dim() - 1))


def _words(x: torch.Tensor) -> torch.Tensor:
    """(2n, ...) limbs -> (n, ...) words x[2j] + x[2j+1] 2^16 (lazy limbs
    stay lazy: a word is below 2^17 times the largest limb)."""
    return x[0::2] + (x[1::2] << LIMB_BITS)


def _limbs(w: torch.Tensor) -> torch.Tensor:
    """(n, ...) canonical 32-bit words -> (2n, ...) 16-bit limbs."""
    return torch.stack([w & LIMB_MASK, w >> LIMB_BITS], dim=1).flatten(0, 1)


def _carry_words(w: torch.Tensor):
    """Exact carry along lazy words (each < 2^62) -> (canonical 32-bit
    words, carry out)."""
    outs = []
    carry = 0
    for col in w.unbind(0):
        v = col + carry
        outs.append(v & WORD_MASK)
        carry = v >> 32
    return torch.stack(outs), carry


def _sub_words(a: torch.Tensor, b: torch.Tensor):
    """a - b over canonical 32-bit words -> (difference mod 2^(32n),
    borrow mask: True where a < b)."""
    outs = []
    neg = 0                                   # -borrow: 0 or -1
    for ca, cb in zip(*torch.broadcast_tensors(a, b)):
        t = ca - cb + neg                     # in [-2^32, 2^32)
        outs.append(t & WORD_MASK)            # two's complement: exact mod 2^32
        neg = t >> 63
    return torch.stack(outs), neg != 0


def _cond_sub(w: torch.Tensor, p_col: torch.Tensor) -> torch.Tensor:
    """Canonical words in [0, 2p) -> [0, p)."""
    diff, borrow = _sub_words(w, p_col)
    return torch.where(borrow, w, diff)


def _conv(a, b, out_limbs: int = 2 * L):
    """Lazy schoolbook product of limb-major int64 numbers:
    (16, ...) x (16, ...) -> (out_limbs, ...) low limbs of the product."""
    batch = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    out = torch.zeros((out_limbs,) + batch, dtype=torch.int64, device=a.device)
    for i in range(min(L, out_limbs)):
        k = min(L, out_limbs - i)
        out[i : i + k].addcmul_(a[i], b[:k])
    return out


def _mont_mul_lm(spec: FieldSpec, a, b):
    """Full-width SOS/REDC on canonical limb-major int64 limbs -> canonical
    (8, ...) 32-bit words of abR^{-1} mod p.

    T = ab stays lazy (limbs < 16 * 2^32); m = T n' mod R reads only T's
    low half (limbs < 2^56 before its carry); T + mp < 2^511 is carried
    once, exactly, and its high half is (T + mp) / R < 2p."""
    t = _conv(a, b)
    m = _conv(t[:L], _col(spec, "nprime_limbs", t), L)
    hi = m >> LIMB_BITS                       # one carry round: limbs < 2^41,
    m = m & LIMB_MASK                         # so the words stay < 2^58
    m[1:] += hi[:-1]
    m, _ = _carry_words(_words(m))            # mod R: the carry out is dropped
    s, _ = _carry_words(_words(t + _conv(_limbs(m), _col(spec, "p_limbs", t))))
    return _cond_sub(s[L // 2 :], _col(spec, "p_words", t))


def mont_mul_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product abR^{-1} mod p; (..., 16) int32 canonical in/out.

    Plain PyTorch version of kernel K1 (and of the in-kernel multiply of
    K2-K6, K8, K9).  Broadcasts a against b.
    """
    a, b = torch.broadcast_tensors(a, b)
    return _out(_limbs(_mont_mul_lm(spec, _lm(a), _lm(b))))


def add_mod(spec: FieldSpec, a, b):
    """(a + b) mod p, canonical in/out (a + b < 2p < 2^256: no carry out)."""
    s, _ = _carry_words(_words(_lm(a) + _lm(b)))
    return _out(_limbs(_cond_sub(s, _col(spec, "p_words", s))))


def sub_mod(spec: FieldSpec, a, b):
    """(a - b) mod p, canonical in/out."""
    d, borrow = _sub_words(_words(_lm(a)), _words(_lm(b)))
    fixed, _ = _carry_words(d + _col(spec, "p_words", d))   # d + p - 2^256
    return _out(_limbs(torch.where(borrow, fixed, d)))


def neg_mod(spec: FieldSpec, a):
    return sub_mod(spec, torch.zeros_like(a), a)


# ---------------------------------------------------------------------------
# Dispatcher: CUDA tensor -> kernel K1, CPU tensor -> plain version
# ---------------------------------------------------------------------------


def _k1_operand(x: torch.Tensor, shape):
    """(tensor, limb stride, element stride) of a K1 operand."""
    if x.numel() == L:                       # one constant for every element
        return x.contiguous(), 1, 0
    x = x.expand(shape).contiguous()         # a no-op for the common case
    return x, 1, L


def mont_mul_k1(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Kernel K1 on CUDA tensors: (..., 16) int32 in/out, broadcasting.

    The kernel sees each operand as a (16, N) plane view with limb and
    element strides (1, 16), or (1, 0) for a broadcast constant."""
    from .. import kernels as K

    dev = K.launch_device("mont_mul", a, b)
    shape = torch.broadcast_shapes(a.shape, b.shape)
    if shape[-1] != L:
        raise ValueError(f"mont_mul: trailing limb axis must be {L}, got {shape}")
    out = torch.empty(shape, dtype=torch.int32, device=dev)
    n = out.numel() // L
    if n == 0:
        return out
    (ta, a_ls, a_es), (tb, b_ls, b_es) = _k1_operand(a, shape), _k1_operand(b, shape)
    K.launch("mont_mul", ta.data_ptr(), a_ls, a_es, tb.data_ptr(), b_ls, b_es,
             out.data_ptr(), 1, L, n, spec.field_id, device=dev)
    return out


def mont_mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product abR^{-1} mod p. a, b: (..., 16) int32 canonical,
    broadcast against each other.  CUDA -> K1, CPU -> plain version."""
    if a.is_cuda or b.is_cuda:
        return mont_mul_k1(spec, a, b)
    return mont_mul_plain(spec, a, b)


def reduce_wide(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Reduce lazy int64 limbs (each in [0, 2^47)) to canonical [0, p).

    The JAX package bounds its u32 inputs to < 2^32 per limb; the int64
    carry here is exact up to 2^47 per limb (2^31 addends of 16 bits), so
    the 2^256-carry can reach 2^48 and is folded back as three limbs with
    one Montgomery multiply by R^2 (mont_mul(c, R2) = c * 2^256 mod p).
    """
    canon, carry = carry_canonical(_lm(a), dim=0)
    carry_limbs = torch.stack(
        [carry & LIMB_MASK, (carry >> LIMB_BITS) & LIMB_MASK, carry >> (2 * LIMB_BITS)]
    )
    carry_limbs = F.pad(_out(carry_limbs), (0, L - 3))
    fold = mont_mul(spec, carry_limbs, spec.const("r2_limbs", a.device).to(torch.int32))
    for name in ("p4_limbs", "p2_limbs", "p_limbs"):      # 2^256 < 6p
        diff, borrow = sub_borrow(canon, _col(spec, name, canon), dim=0)
        canon = torch.where(borrow == 0, diff, canon)
    return add_mod(spec, _out(canon), fold)


def mont_pow_bits_plain(spec: FieldSpec, a: torch.Tensor, exp_bits: np.ndarray):
    """a^e for a fixed public exponent given as an LSB-first bit array: the
    binary chain over mont_mul_plain, on any device.  Plain version of
    kernel mont_pow."""
    acc = torch.broadcast_to(
        spec.const("one_mont", a.device).to(torch.int32), a.shape
    ).contiguous()
    base = a
    for bit in np.asarray(exp_bits).tolist():
        if bit:
            acc = mont_mul_plain(spec, acc, base)
        base = mont_mul_plain(spec, base, base)
    return acc


def pack_exponent(exp_bits) -> tuple[list, int]:
    """An LSB-first bit array -> (8 little-endian 32-bit words, bit length:
    the highest set bit's index + 1, 0 for e = 0).  At most 256 bits."""
    bits = [int(b) for b in np.asarray(exp_bits).reshape(-1).tolist()]
    if len(bits) > 256:
        raise ValueError(f"exponent of {len(bits)} bits: at most 256")
    if any(b not in (0, 1) for b in bits):
        raise ValueError("exponent bits must be 0 or 1")
    e = sum(b << i for i, b in enumerate(bits))
    return [(e >> (32 * j)) & 0xFFFFFFFF for j in range(8)], e.bit_length()


def mont_pow_k1(spec: FieldSpec, a: torch.Tensor, exp_bits) -> torch.Tensor:
    """Kernel mont_pow on a CUDA tensor: a^e for every element in ONE
    launch, (..., 16) int32 Montgomery form in, a new tensor out.  The
    kernel reads contiguous elements (a copy is made of anything else) and
    uses 16-byte loads where the data is 16-byte aligned."""
    from .. import kernels as K

    dev = K.launch_device("mont_pow", a)
    if a.dim() < 1 or a.shape[-1] != L:
        raise ValueError(f"mont_pow: trailing limb axis must be {L}, got {tuple(a.shape)}")
    words, nbits = pack_exponent(exp_bits)
    a = a.contiguous()
    out = torch.empty_like(a)
    n = a.numel() // L
    if n:
        exp_words = (ctypes.c_uint32 * 8)(*words)      # read by the launcher before it returns
        K.launch("mont_pow", a.data_ptr(), out.data_ptr(), n,
                 ctypes.addressof(exp_words), nbits, spec.field_id, device=dev)
    return out


def mont_pow_bits(spec: FieldSpec, a: torch.Tensor, exp_bits: np.ndarray):
    """a^e for a fixed public exponent given as an LSB-first bit array of at
    most 256 bits; 0^e = 0 for e > 0, a^0 = 1.  CUDA -> one mont_pow launch,
    CPU -> the plain chain."""
    if a.is_cuda:
        return mont_pow_k1(spec, a, exp_bits)
    pack_exponent(exp_bits)                       # the same limits on both devices
    return mont_pow_bits_plain(spec, a, exp_bits)


def mont_inv(spec: FieldSpec, a):
    """Batched inversion via Fermat: a^(p-2); 0 maps to 0."""
    return mont_pow_bits(spec, a, spec.exp_p_minus_2_bits)


def to_mont(spec: FieldSpec, x):
    """Canonical limbs (plain domain) -> Montgomery domain."""
    return mont_mul(spec, x, spec.const("r2_limbs", x.device).to(torch.int32))


def from_mont(spec: FieldSpec, x):
    """Montgomery domain -> plain domain limbs."""
    one = torch.zeros(L, dtype=torch.int32, device=x.device)
    one[0] = 1
    return mont_mul(spec, x, one)


# ---------------------------------------------------------------------------
# Host boundary conversions (numpy)
# ---------------------------------------------------------------------------


def encode_ints(spec: FieldSpec, xs) -> np.ndarray:
    """Host ints -> Montgomery-domain limb array (len(xs), 16) uint32."""
    return ints_to_limbs([(x % spec.p) * spec.r_mod % spec.p for x in xs])


def decode_ints(spec: FieldSpec, limbs) -> list:
    """Montgomery-domain limb array (..., 16) -> list of ints."""
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.cpu().numpy()
    arr = np.asarray(limbs).astype("<u2").reshape(-1, L)
    rinv = pow(params.MONT_R, -1, spec.p)
    return [
        int.from_bytes(row.tobytes(), "little") * rinv % spec.p for row in arr
    ]
