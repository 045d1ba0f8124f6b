"""The optimal ate pairing on BN254, in its all-Fq12 textbook form: the
Miller loop on the untwisted curve with every line evaluated in Fq12 and
each Frobenius a computed q-th power, and the final exponentiation as
plain powers, (q^6 - 1)(q^2 + 1) then (q^4 - q^2 + 1) / r.

The program verifies with another formulation (a shared Miller loop in
twisted coordinates with sparse line products, the hard part of the final
exponentiation by the base-q digits of its exponent), so a fault in that
fast path cannot hide in the yardstick.
"""

from __future__ import annotations

from .hostcurve import CurvePoint, g1_to_fq12, untwist
from .hostfield import Fq12
from .params import ATE_LOOP_COUNT, Q, R

_EASY2_EXP = Q * Q
_HARD_EXP = (Q**4 - Q**2 + 1) // R
assert (Q**4 - Q**2 + 1) % R == 0


def _frobenius_point(p: CurvePoint) -> CurvePoint:
    """The q-power Frobenius endomorphism on E(Fq12)."""
    if p.inf:
        return p
    return CurvePoint(p.x.pow(Q), p.y.pow(Q), p.b)


def _line(a: CurvePoint, b: CurvePoint, xp: Fq12, yp: Fq12) -> Fq12:
    """The line through points a, b of E(Fq12), evaluated at (xp, yp)."""
    if a.inf or b.inf:
        return Fq12.ONE
    if a.x == b.x:
        if a.y == b.y and not a.y.is_zero():
            xx = a.x.square()
            lam = (xx + xx + xx) * (a.y + a.y).inverse()
        else:
            return xp - a.x                         # vertical line
    else:
        lam = (b.y - a.y) * (b.x - a.x).inverse()
    return (yp - a.y) - lam * (xp - a.x)


def miller_loop(q_twisted: CurvePoint, p_g1: CurvePoint) -> Fq12:
    """f_{6u+2, Q}(P) times the two Frobenius lines, all in Fq12."""
    if q_twisted.inf or p_g1.inf:
        return Fq12.ONE
    qq = untwist(q_twisted)
    pp = g1_to_fq12(p_g1)
    xp, yp = pp.x, pp.y
    f = Fq12.ONE
    t = qq
    for i in range(ATE_LOOP_COUNT.bit_length() - 2, -1, -1):
        f = f.square() * _line(t, t, xp, yp)
        t = t.double()
        if (ATE_LOOP_COUNT >> i) & 1:
            f = f * _line(t, qq, xp, yp)
            t = t + qq
    q1 = _frobenius_point(qq)
    q2 = _frobenius_point(q1)
    f = f * _line(t, q1, xp, yp)
    t = t + q1
    return f * _line(t, -q2, xp, yp)


def final_exponentiation(f: Fq12) -> Fq12:
    """f^((q^12 - 1) / r) by square-and-multiply."""
    f1 = f.conjugate() * f.inverse()
    f2 = f1.pow(_EASY2_EXP) * f1
    return f2.pow(_HARD_EXP)


def pairing_product_is_one(pairs) -> bool:
    """Whether prod e(P_i, Q_i) == 1 over pairs (P_i in G1, Q_i in G2)."""
    f = Fq12.ONE
    for p, q in pairs:
        f = f * miller_loop(q, p)
    return final_exponentiation(f) == Fq12.ONE
