"""BN254 field tower on Python integers: Fq, Fq2 = Fq[u]/(u^2 + 1),
Fq6 = Fq2[v]/(v^3 - xi) with xi = 9 + u, Fq12 = Fq6[w]/(w^2 - v).

A frozen copy of the same module of zklaim_tpu_torch, kept for the
benchmark's plain reference: the code is the program's at the time the
benchmark was written, with imports relative to this folder, so that a
later change to the program does not change the yardstick.
"""
from __future__ import annotations

from .params import Q, XI

# ---------------------------------------------------------------------------
# Prime fields as plain ints (mod p); helpers only -- callers track the modulus
# ---------------------------------------------------------------------------


def inv_mod(a: int, p: int) -> int:
    return pow(a, -1, p)


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


Fq12.ZERO = Fq12(Fq6.ZERO, Fq6.ZERO)
Fq12.ONE = Fq12(Fq6.ONE, Fq6.ZERO)
