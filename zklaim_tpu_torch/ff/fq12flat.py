"""Allocation-free Fq12 arithmetic on flat int lists (pairing hot path).

The class tower in hostfield.py is the readable golden model, but the
verifier's Miller loop + final exponentiation execute ~10^5 Fq2
operations and CPython object construction dominates their cost (~70%
measured).  This module re-implements exactly the operations the
pairing needs on a FLAT representation: an Fq12 element is a 12-int
list [a0.c0, a0.c1, a1.c0, a1.c1, ..., a5.c0, a5.c1] of w-basis
coefficients (w^2 = v, w^6 = xi; see hostfield.Fq12.to_flat).

Every function here is tested against the hostfield tower classes
(tests/test_hostfield.py); the Frobenius gamma constants are computed
from xi at import, never transcribed.

Replaces the performance role of libff's hand-scheduled Fp12 assembly
paths (reference reaches them through libsnark's verifier,
zklaim/snark.cpp:62).

Copy of zklaim_tpu/ff/fq12flat.py kept inside this package, which imports nothing
of the JAX package: the code is identical, and the relative imports
resolve to this package's own copies.
"""

from __future__ import annotations

from .hostfield import Fq2, Fq6, Fq12, _FROB_GAMMA1
from .params import Q

# Frobenius constants as int pairs
_G1P = [(g.c0, g.c1) for g in _FROB_GAMMA1]

ONE = [1, 0] + [0] * 10


def from_fq12(x: Fq12) -> list:
    f = x.to_flat()
    out = []
    for c in f:
        out.append(c.c0)
        out.append(c.c1)
    return out


def to_fq12(v) -> Fq12:
    cs = [Fq2(v[2 * k], v[2 * k + 1]) for k in range(6)]
    return Fq12(Fq6(cs[0], cs[2], cs[4]), Fq6(cs[1], cs[3], cs[5]))


# -- Fq2 primitives on int pairs (inputs canonical, outputs canonical) ----


def m2(a0, a1, b0, b1):
    t0 = a0 * b0
    t1 = a1 * b1
    t2 = (a0 + a1) * (b0 + b1)
    return (t0 - t1) % Q, (t2 - t0 - t1) % Q


def s2(a0, a1):
    return ((a0 + a1) * (a0 - a1)) % Q, (2 * a0 * a1) % Q


def mx(a0, a1):
    """Multiply by xi = 9 + u."""
    return (9 * a0 - a1) % Q, (a0 + 9 * a1) % Q


# -- Fq12 operations ------------------------------------------------------


def f_mul(a, b):
    """Schoolbook over the w-basis: 36 Fq2 products, single mod per
    output component (intermediate sums stay unreduced)."""
    # unreduced Fq2 products: (i, j) contributes to coefficient i+j,
    # wrapped by xi beyond w^5
    acc = [0] * 24  # 12 unreduced (re, im) sums
    for i in range(6):
        ar, ai = a[2 * i], a[2 * i + 1]
        if ar == 0 and ai == 0:
            continue
        for j in range(6):
            br, bj = b[2 * j], b[2 * j + 1]
            if br == 0 and bj == 0:
                continue
            t0 = ar * br
            t1 = ai * bj
            t2 = (ar + ai) * (br + bj)
            re = t0 - t1
            im = t2 - t0 - t1
            k = i + j
            if k >= 6:
                k -= 6
                re, im = 9 * re - im, re + 9 * im
            acc[2 * k] += re
            acc[2 * k + 1] += im
    return [x % Q for x in acc]


def f_sqr(a):
    return f_mul(a, a)


def f_conj(a):
    """Unitary inverse x -> x^(q^6): negate odd w-powers."""
    return [
        a[0], a[1], (-a[2]) % Q, (-a[3]) % Q, a[4], a[5],
        (-a[6]) % Q, (-a[7]) % Q, a[8], a[9], (-a[10]) % Q, (-a[11]) % Q,
    ]


def f_frob(a):
    """x -> x^q: conjugate each Fq2 coefficient, times gamma1^k."""
    out = []
    for k in range(6):
        c0, c1 = a[2 * k], (-a[2 * k + 1]) % Q
        g0, g1 = _G1P[k]
        r0, r1 = m2(c0, c1, g0, g1)
        out.append(r0)
        out.append(r1)
    return out


def f_cyc_sqr(a):
    """Granger-Scott cyclotomic squaring (valid in the cyclotomic
    subgroup only); formula verified against f_sqr in tests."""

    def sq4(x0, x1, y0, y1):
        # (x + y s)^2, s^2 = xi: returns (x^2 + xi y^2, (x+y)^2 - x^2 - y^2)
        t00, t01 = s2(x0, x1)
        t10, t11 = s2(y0, y1)
        u0, u1 = s2((x0 + y0) % Q, (x1 + y1) % Q)
        w0, w1 = mx(t10, t11)
        return (
            (t00 + w0) % Q, (t01 + w1) % Q,
            (u0 - t00 - t10) % Q, (u1 - t01 - t11) % Q,
        )

    a0, a1 = a[0], a[1]
    a2_, a3_ = a[2], a[3]
    a4_, a5_ = a[4], a[5]
    b0, b1 = a[6], a[7]      # w^3 coeff
    b2_, b3_ = a[8], a[9]    # w^4
    b4_, b5_ = a[10], a[11]  # w^5

    # pairs (w^0, w^3), (w^1, w^4), (w^2, w^5)
    t00, t01, t0b0, t0b1 = sq4(a0, a1, b0, b1)
    t10, t11, t1b0, t1b1 = sq4(a2_, a3_, b2_, b3_)
    t20, t21, t2b0, t2b1 = sq4(a4_, a5_, b4_, b5_)

    out = [0] * 12
    out[0] = (3 * t00 - 2 * a0) % Q
    out[1] = (3 * t01 - 2 * a1) % Q
    out[6] = (3 * t0b0 + 2 * b0) % Q
    out[7] = (3 * t0b1 + 2 * b1) % Q
    w0, w1 = mx(t2b0, t2b1)
    out[2] = (3 * w0 + 2 * a2_) % Q
    out[3] = (3 * w1 + 2 * a3_) % Q
    out[8] = (3 * t20 - 2 * b2_) % Q
    out[9] = (3 * t21 - 2 * b3_) % Q
    out[4] = (3 * t10 - 2 * a4_) % Q
    out[5] = (3 * t11 - 2 * a5_) % Q
    out[10] = (3 * t1b0 + 2 * b4_) % Q
    out[11] = (3 * t1b1 + 2 * b5_) % Q
    return out


def f_pow_cyc(a, e: int):
    """a^e with cyclotomic squarings; negative e via (free) conjugate."""
    if e < 0:
        return f_pow_cyc(f_conj(a), -e)
    if e == 0:
        return list(ONE)
    r = a
    for bit in bin(e)[3:]:
        r = f_cyc_sqr(r)
        if bit == "1":
            r = f_mul(r, a)
    return r


def mul_line(f, k0: int, k1, k3):
    """f * (k0 + k1 w + k3 w^3): k0 in Fq, k1/k3 int pairs.  The sparse
    shape produced by the twisted-coordinate Miller loop line."""
    k10, k11 = k1
    k30, k31 = k3
    acc = [0] * 24
    for i in range(6):
        ar, ai = f[2 * i], f[2 * i + 1]
        # * k0 -> position i
        acc[2 * i] += ar * k0
        acc[2 * i + 1] += ai * k0
        # * k1 w -> position i+1
        t0 = ar * k10
        t1 = ai * k11
        t2 = (ar + ai) * (k10 + k11)
        re, im = t0 - t1, t2 - t0 - t1
        k = i + 1
        if k >= 6:
            k -= 6
            re, im = 9 * re - im, re + 9 * im
        acc[2 * k] += re
        acc[2 * k + 1] += im
        # * k3 w^3 -> position i+3
        t0 = ar * k30
        t1 = ai * k31
        t2 = (ar + ai) * (k30 + k31)
        re, im = t0 - t1, t2 - t0 - t1
        k = i + 3
        if k >= 6:
            k -= 6
            re, im = 9 * re - im, re + 9 * im
        acc[2 * k] += re
        acc[2 * k + 1] += im
    return [x % Q for x in acc]


def f_is_one(a) -> bool:
    return a[0] == 1 and all(x == 0 for x in a[1:])
