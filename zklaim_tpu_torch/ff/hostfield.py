"""Host-side (Python int) golden-model field arithmetic for BN254.

This is the exact reference model against which every TPU kernel in
zklaim_tpu.ff.limbs / zklaim_tpu.ff.montgomery is tested, and it is also the
production path for inherently scalar work (pairing-based verification,
trusted-setup toxic-waste sampling) where a 254-bit Python int beats a
vectorized kernel on latency.

Replaces (TPU-first, not a translation): libff's Fp_model/Fp2/Fp6_3over2/
Fp12_2over3over2 used by the reference via libsnark (see SURVEY.md L1).

Tower construction (matching alt_bn128):
    Fq2  = Fq[u]  / (u^2 + 1)
    Fq6  = Fq2[v] / (v^3 - xi),  xi = 9 + u
    Fq12 = Fq6[w] / (w^2 - v)

Copy of zklaim_tpu/ff/hostfield.py kept inside this package, which imports nothing
of the JAX package: the code is identical, and the relative imports
resolve to this package's own copies.
"""

from __future__ import annotations

from .params import Q, R, XI

# ---------------------------------------------------------------------------
# Prime fields as plain ints (mod p); helpers only -- callers track the modulus
# ---------------------------------------------------------------------------


def inv_mod(a: int, p: int) -> int:
    return pow(a, -1, p)


def batch_inverse(values, p: int):
    """Montgomery trick: invert a list of nonzero ints mod p with 1 inversion."""
    n = len(values)
    if n == 0:
        return []
    prefix = [1] * (n + 1)
    for i, v in enumerate(values):
        prefix[i + 1] = (prefix[i] * v) % p
    inv_all = pow(prefix[n], -1, p)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = (prefix[i] * inv_all) % p
        inv_all = (inv_all * values[i]) % p
    return out


# ---------------------------------------------------------------------------
# Fq (wrapper class so curve code can be generic over the tower)
# ---------------------------------------------------------------------------


class Fq:
    __slots__ = ("v",)
    ZERO: "Fq"
    ONE: "Fq"

    def __init__(self, v: int):
        self.v = v % Q

    def __eq__(self, o):
        return isinstance(o, Fq) and self.v == o.v

    def __hash__(self):
        return hash(self.v)

    def __repr__(self):
        return f"Fq({self.v})"

    def __add__(self, o):
        return Fq(self.v + o.v)

    def __sub__(self, o):
        return Fq(self.v - o.v)

    def __neg__(self):
        return Fq(-self.v)

    def __mul__(self, o):
        if isinstance(o, int):
            return Fq(self.v * o)
        return Fq(self.v * o.v)

    __rmul__ = __mul__

    def square(self):
        return Fq(self.v * self.v)

    def inverse(self):
        return Fq(pow(self.v, -1, Q))

    def is_zero(self):
        return self.v == 0


Fq.ZERO = Fq(0)
Fq.ONE = Fq(1)


# ---------------------------------------------------------------------------
# Fq2
# ---------------------------------------------------------------------------


class Fq2:
    """c0 + c1*u with u^2 = -1 over Fq."""

    __slots__ = ("c0", "c1")
    ZERO: "Fq2"
    ONE: "Fq2"

    def __init__(self, c0: int, c1: int):
        self.c0 = c0 % Q
        self.c1 = c1 % Q

    def __eq__(self, o):
        return isinstance(o, Fq2) and self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self):
        return hash((self.c0, self.c1))

    def __repr__(self):
        return f"Fq2({self.c0}, {self.c1})"

    def __add__(self, o):
        return Fq2(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return Fq2(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self):
        return Fq2(-self.c0, -self.c1)

    def __mul__(self, o):
        if isinstance(o, int):
            return Fq2(self.c0 * o, self.c1 * o)
        # Karatsuba: (a0 + a1 u)(b0 + b1 u) = a0b0 - a1b1 + ((a0+a1)(b0+b1) - a0b0 - a1b1) u
        t0 = self.c0 * o.c0
        t1 = self.c1 * o.c1
        t2 = (self.c0 + self.c1) * (o.c0 + o.c1)
        return Fq2(t0 - t1, t2 - t0 - t1)

    __rmul__ = __mul__

    def square(self):
        # (a0 + a1 u)^2 = (a0+a1)(a0-a1) + 2 a0 a1 u
        t = self.c0 * self.c1
        return Fq2((self.c0 + self.c1) * (self.c0 - self.c1), 2 * t)

    def inverse(self):
        # 1/(a0 + a1 u) = (a0 - a1 u) / (a0^2 + a1^2)
        norm = (self.c0 * self.c0 + self.c1 * self.c1) % Q
        ninv = inv_mod(norm, Q)
        return Fq2(self.c0 * ninv, -self.c1 * ninv)

    def conjugate(self):
        return Fq2(self.c0, -self.c1)

    def frobenius(self):
        # x^q = conjugate for quadratic extension
        return self.conjugate()

    def mul_by_nonresidue(self):
        """Multiply by xi = 9 + u (the Fq6 cubic non-residue)."""
        # (c0 + c1 u)(9 + u) = 9c0 - c1 + (c0 + 9c1) u
        return Fq2(9 * self.c0 - self.c1, self.c0 + 9 * self.c1)

    def is_zero(self):
        return self.c0 == 0 and self.c1 == 0

    def pow(self, e: int):
        result = Fq2.ONE
        base = self
        while e > 0:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result


Fq2.ZERO = Fq2(0, 0)
Fq2.ONE = Fq2(1, 0)
XI_FQ2 = Fq2(*XI)


# ---------------------------------------------------------------------------
# Fq6 = Fq2[v]/(v^3 - xi)
# ---------------------------------------------------------------------------


class Fq6:
    __slots__ = ("c0", "c1", "c2")
    ZERO: "Fq6"
    ONE: "Fq6"

    def __init__(self, c0: Fq2, c1: Fq2, c2: Fq2):
        self.c0, self.c1, self.c2 = c0, c1, c2

    def __eq__(self, o):
        return self.c0 == o.c0 and self.c1 == o.c1 and self.c2 == o.c2

    def __repr__(self):
        return f"Fq6({self.c0}, {self.c1}, {self.c2})"

    def __add__(self, o):
        return Fq6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o):
        return Fq6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __neg__(self):
        return Fq6(-self.c0, -self.c1, -self.c2)

    def __mul__(self, o):
        if isinstance(o, (int, Fq2)):
            return Fq6(self.c0 * o, self.c1 * o, self.c2 * o)
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        t0 = a0 * b0
        t1 = a1 * b1
        t2 = a2 * b2
        c0 = ((a1 + a2) * (b1 + b2) - t1 - t2).mul_by_nonresidue() + t0
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + t2.mul_by_nonresidue()
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return Fq6(c0, c1, c2)

    __rmul__ = __mul__

    def square(self):
        return self * self

    def mul_by_nonresidue(self):
        """Multiply by v (used in Fq12 arithmetic): (c0,c1,c2) -> (xi*c2, c0, c1)."""
        return Fq6(self.c2.mul_by_nonresidue(), self.c0, self.c1)

    def inverse(self):
        a0, a1, a2 = self.c0, self.c1, self.c2
        t0 = a0.square() - (a1 * a2).mul_by_nonresidue()
        t1 = a2.square().mul_by_nonresidue() - a0 * a1
        t2 = a1.square() - a0 * a2
        denom = a0 * t0 + (a2 * t1 + a1 * t2).mul_by_nonresidue()
        dinv = denom.inverse()
        return Fq6(t0 * dinv, t1 * dinv, t2 * dinv)

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()


Fq6.ZERO = Fq6(Fq2.ZERO, Fq2.ZERO, Fq2.ZERO)
Fq6.ONE = Fq6(Fq2.ONE, Fq2.ZERO, Fq2.ZERO)


# ---------------------------------------------------------------------------
# Fq12 = Fq6[w]/(w^2 - v)
# ---------------------------------------------------------------------------


class Fq12:
    __slots__ = ("c0", "c1")
    ZERO: "Fq12"
    ONE: "Fq12"

    def __init__(self, c0: Fq6, c1: Fq6):
        self.c0, self.c1 = c0, c1

    def __eq__(self, o):
        return self.c0 == o.c0 and self.c1 == o.c1

    def __repr__(self):
        return f"Fq12({self.c0}, {self.c1})"

    def __add__(self, o):
        return Fq12(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return Fq12(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self):
        return Fq12(-self.c0, -self.c1)

    def __mul__(self, o):
        if isinstance(o, int):
            return Fq12(self.c0 * o, self.c1 * o)
        a0, a1 = self.c0, self.c1
        b0, b1 = o.c0, o.c1
        t0 = a0 * b0
        t1 = a1 * b1
        return Fq12(t0 + t1.mul_by_nonresidue(), (a0 + a1) * (b0 + b1) - t0 - t1)

    __rmul__ = __mul__

    def square(self):
        a0, a1 = self.c0, self.c1
        t = a0 * a1
        c0 = (a0 + a1) * (a0 + a1.mul_by_nonresidue()) - t - t.mul_by_nonresidue()
        return Fq12(c0, t + t)

    def inverse(self):
        denom = self.c0 * self.c0 - (self.c1 * self.c1).mul_by_nonresidue()
        dinv = denom.inverse()
        return Fq12(self.c0 * dinv, -(self.c1 * dinv))

    def conjugate(self):
        """x -> x^(q^6): negate the w-coefficient (cheap cyclotomic inverse)."""
        return Fq12(self.c0, -self.c1)

    def pow(self, e: int):
        if e < 0:
            return self.inverse().pow(-e)
        result = Fq12.ONE
        base = self
        while e > 0:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    def is_one(self):
        return self == Fq12.ONE

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero()

    # -- flat w-basis view ------------------------------------------------
    # An Fq12 element is sum_{k=0}^{5} a_k w^k with a_k in Fq2 (w^2 = v,
    # w^6 = xi).  Tower coords interleave: c0 = (a0, a2, a4), c1 w =
    # (a1, a3, a5) w.  The flat view makes Frobenius and sparse line
    # multiplication (pairing Miller loop) one-liners.

    def to_flat(self):
        return [
            self.c0.c0, self.c1.c0, self.c0.c1,
            self.c1.c1, self.c0.c2, self.c1.c2,
        ]

    @staticmethod
    def from_flat(a):
        return Fq12(Fq6(a[0], a[2], a[4]), Fq6(a[1], a[3], a[5]))

    def frobenius(self):
        """x -> x^q.  a_k w^k -> conj(a_k) * gamma1^k * w^k, with
        gamma1 = w^(q-1) = xi^((q-1)/6) in Fq2 COMPUTED at import (no
        transcribed endomorphism constants)."""
        a = self.to_flat()
        return Fq12.from_flat(
            [a[k].conjugate() * _FROB_GAMMA1[k] for k in range(6)]
        )

    def cyclotomic_square(self):
        """Squaring for elements of the cyclotomic subgroup (where
        conjugate == inverse).  Granger-Scott compressed squaring over
        the implicit Fq4 sub-tower: ~9 Fq2 mults vs 18 for a generic
        square — the workhorse of the final exponentiation hard part."""
        a = self.to_flat()
        # Fq4 pairs (w^0, w^3), (w^1, w^4), (w^2, w^5); Fq4 nonresidue
        # for pair arithmetic is v (w^6 = xi handled via gamma):
        # standard GS: z0..z5 grouped as (z0,z4),(z3,z2),(z1,z5) in
        # library conventions — here derived directly on w-powers:
        # (x + y w^3)^2 over Fq2[w^3]/(w^6 - xi): w^3 squared = xi.
        def sq_fq4(x, y):
            # (x + y s)^2 with s^2 = xi: (x^2 + xi y^2, 2xy)
            t0 = x.square()
            t1 = y.square()
            return t0 + t1.mul_by_nonresidue(), (x + y).square() - t0 - t1

        t00, t01 = sq_fq4(a[0], a[3])
        t10, t11 = sq_fq4(a[1], a[4])
        t20, t21 = sq_fq4(a[2], a[5])
        out = [Fq2.ZERO] * 6
        # Granger–Scott recombination: for g = g0 + g1 w^3 pairs,
        # g'_even = 3 t_even - 2 conj(g_even), g'_odd = 3 t_odd + 2 g_odd
        # with the cross pair rotated by xi.  Derived/verified against
        # generic square in tests (test_hostfield).
        out[0] = (t00 - a[0]) * 2 + t00
        out[3] = (t01 + a[3]) * 2 + t01
        out[1] = (t21.mul_by_nonresidue() + a[1]) * 2 + t21.mul_by_nonresidue()
        out[4] = (t20 - a[4]) * 2 + t20
        out[2] = (t10 - a[2]) * 2 + t10
        out[5] = (t11 + a[5]) * 2 + t11
        return Fq12.from_flat(out)

    def pow_cyclotomic(self, e: int):
        """Square-and-multiply using cyclotomic squarings; negative
        exponents use the (free) conjugate.  Only valid inside the
        cyclotomic subgroup (after the easy final-exp part)."""
        if e < 0:
            return self.conjugate().pow_cyclotomic(-e)
        if e == 0:
            return Fq12.ONE
        result = self
        for bit in bin(e)[3:]:  # MSB-first, skip the leading 1
            result = result.cyclotomic_square()
            if bit == "1":
                result = result * self
        return result


Fq12.ZERO = Fq12(Fq6.ZERO, Fq6.ZERO)
Fq12.ONE = Fq12(Fq6.ONE, Fq6.ZERO)

# Frobenius twist constants, computed (not transcribed): gamma1^k =
# xi^(k(q-1)/6).  q = 1 mod 6 so the exponent is integral.
_FROB_G = XI_FQ2.pow((Q - 1) // 6)
_FROB_GAMMA1 = [Fq2.ONE]
for _ in range(5):
    _FROB_GAMMA1.append(_FROB_GAMMA1[-1] * _FROB_G)
