"""Host-side (Python int) elliptic-curve golden model for BN254 G1/G2.

Generic short-Weierstrass arithmetic over any field of the zklaim_tpu.ff
tower (Fq, Fq2, Fq12).  This is the exactness reference for the batched
TPU point kernels (zklaim_tpu/ec/jaxcurve.py) and the production path for
single-point work (generator table construction, verification).

Replaces libff's alt_bn128_G1/alt_bn128_G2 used by the reference through
libsnark (SURVEY.md L1; reference links libff per zklaim/compileMe.txt:2-4).

Copy of zklaim_tpu/ec/hostcurve.py kept inside this package, which imports nothing
of the JAX package: the code is identical, and the relative imports
resolve to this package's own copies.
"""

from __future__ import annotations

from ..ff.hostfield import Fq, Fq2, Fq6, Fq12, XI_FQ2
from ..ff.params import G1_B, G1_GEN, G2_GEN_X, G2_GEN_Y, Q, R


def _jac_mul_fq(px: int, py: int, k: int):
    """Plain-int Jacobian ladder over Fq (G1): the class-based generic
    ladder spends most of its time in Fq.__init__/%-dispatch; raw ints
    run ~10x faster (sub-ms per 256-bit scalar).  Returns affine
    (x, y) ints or None for infinity."""
    X = Y = Z = None
    for bit in bin(k)[2:]:
        if Z is not None and Z != 0:
            if Y == 0:
                Z = 0
            else:
                a = X * X % Q
                b = Y * Y % Q
                c = b * b % Q
                t = X + b
                d = 2 * (t * t - a - c) % Q
                e = 3 * a
                x3 = (e * e - 2 * d) % Q
                y3 = (e * (d - x3) - 8 * c) % Q
                z3 = 2 * Y * Z % Q
                X, Y, Z = x3, y3, z3
        if bit == "1":
            if Z is None or Z == 0:
                X, Y, Z = px, py, 1
            else:
                zz = Z * Z % Q
                u2 = px * zz % Q
                s2 = py * Z % Q * zz % Q
                h = (u2 - X) % Q
                r = (s2 - Y) % Q
                if h == 0:
                    if r == 0:
                        # double instead
                        a = X * X % Q
                        b = Y * Y % Q
                        c = b * b % Q
                        t = X + b
                        d = 2 * (t * t - a - c) % Q
                        e = 3 * a
                        x3 = (e * e - 2 * d) % Q
                        y3 = (e * (d - x3) - 8 * c) % Q
                        z3 = 2 * Y * Z % Q
                        X, Y, Z = x3, y3, z3
                    else:
                        Z = 0
                else:
                    hh = h * h % Q
                    i = 4 * hh % Q
                    j = h * i % Q
                    r2 = 2 * r
                    v = X * i % Q
                    x3 = (r2 * r2 - j - 2 * v) % Q
                    y3 = (r2 * (v - x3) - 2 * Y * j) % Q
                    zh = Z + h
                    z3 = (zh * zh - zz - hh) % Q
                    X, Y, Z = x3, y3, z3
    if Z is None or Z == 0:
        return None
    zinv = pow(Z, -1, Q)
    zinv2 = zinv * zinv % Q
    return (X * zinv2 % Q, Y * zinv2 % Q * zinv % Q)


def _jac_mul_fq2(px, py, k: int):
    """Int-pair Jacobian ladder over Fq2 (G2); same structure as
    _jac_mul_fq.  px, py: (c0, c1) int pairs; returns affine int pairs
    or None for infinity.  The G2 r-order subgroup check in serde runs
    this with k = r on every deserialized vk/proof point."""
    from ..ff.fq12flat import m2, s2

    X = Y = Z = None
    for bit in bin(k)[2:]:
        if Z is not None and Z != (0, 0):
            if Y == (0, 0):
                Z = (0, 0)
            else:
                a = s2(*X)
                b = s2(*Y)
                c = s2(*b)
                t = (X[0] + b[0], X[1] + b[1])
                tt = s2(*t)
                d = (
                    2 * (tt[0] - a[0] - c[0]) % Q,
                    2 * (tt[1] - a[1] - c[1]) % Q,
                )
                e = (3 * a[0] % Q, 3 * a[1] % Q)
                ee = s2(*e)
                x3 = ((ee[0] - 2 * d[0]) % Q, (ee[1] - 2 * d[1]) % Q)
                dm = ((d[0] - x3[0]) % Q, (d[1] - x3[1]) % Q)
                ed = m2(*e, *dm)
                y3 = ((ed[0] - 8 * c[0]) % Q, (ed[1] - 8 * c[1]) % Q)
                yz = m2(*Y, *Z)
                z3 = (2 * yz[0] % Q, 2 * yz[1] % Q)
                X, Y, Z = x3, y3, z3
        if bit == "1":
            if Z is None or Z == (0, 0):
                X, Y, Z = px, py, (1, 0)
            else:
                zz = s2(*Z)
                u2 = m2(*px, *zz)
                s2_ = m2(*m2(*py, *Z), *zz)
                h = ((u2[0] - X[0]) % Q, (u2[1] - X[1]) % Q)
                r = ((s2_[0] - Y[0]) % Q, (s2_[1] - Y[1]) % Q)
                if h == (0, 0):
                    if r == (0, 0):
                        # doubling case: push back through the dbl branch
                        a = s2(*X)
                        b = s2(*Y)
                        c = s2(*b)
                        t = (X[0] + b[0], X[1] + b[1])
                        tt = s2(*t)
                        d = (
                            2 * (tt[0] - a[0] - c[0]) % Q,
                            2 * (tt[1] - a[1] - c[1]) % Q,
                        )
                        e = (3 * a[0] % Q, 3 * a[1] % Q)
                        ee = s2(*e)
                        x3 = ((ee[0] - 2 * d[0]) % Q, (ee[1] - 2 * d[1]) % Q)
                        dm = ((d[0] - x3[0]) % Q, (d[1] - x3[1]) % Q)
                        ed = m2(*e, *dm)
                        y3 = ((ed[0] - 8 * c[0]) % Q, (ed[1] - 8 * c[1]) % Q)
                        yz = m2(*Y, *Z)
                        z3 = (2 * yz[0] % Q, 2 * yz[1] % Q)
                        X, Y, Z = x3, y3, z3
                    else:
                        Z = (0, 0)
                else:
                    hh = s2(*h)
                    i = (4 * hh[0] % Q, 4 * hh[1] % Q)
                    j = m2(*h, *i)
                    r2 = (2 * r[0], 2 * r[1])
                    v = m2(*X, *i)
                    rr = s2(*r2)
                    x3 = (
                        (rr[0] - j[0] - 2 * v[0]) % Q,
                        (rr[1] - j[1] - 2 * v[1]) % Q,
                    )
                    vm = ((v[0] - x3[0]) % Q, (v[1] - x3[1]) % Q)
                    rv = m2(*r2, *vm)
                    yj = m2(*Y, *j)
                    y3 = ((rv[0] - 2 * yj[0]) % Q, (rv[1] - 2 * yj[1]) % Q)
                    zh = (Z[0] + h[0], Z[1] + h[1])
                    zs = s2(*zh)
                    z3 = (
                        (zs[0] - zz[0] - hh[0]) % Q,
                        (zs[1] - zz[1] - hh[1]) % Q,
                    )
                    X, Y, Z = x3, y3, z3
    if Z is None or Z == (0, 0):
        return None
    # invert Z in Fq2: conj / norm
    n0 = (Z[0] * Z[0] + Z[1] * Z[1]) % Q
    ninv = pow(n0, -1, Q)
    zi = (Z[0] * ninv % Q, (-Z[1]) * ninv % Q)
    zi2 = s2(*zi)
    zi3 = m2(*zi2, *zi)
    return (m2(*X, *zi2), m2(*Y, *zi3))


def _jac_double(X1, Y1, Z1):
    """Jacobian doubling on y^2 = x^3 + b (a = 0); generic over Fq/Fq2."""
    if Y1.is_zero():
        return (X1, Y1, type(Z1).ZERO)
    a = X1.square()
    b = Y1.square()
    c = b.square()
    d = (X1 + b).square() - a - c
    d = d + d
    e = a + a + a
    f = e.square()
    x3 = f - d - d
    c8 = c + c
    c8 = c8 + c8
    c8 = c8 + c8
    y3 = e * (d - x3) - c8
    z3 = (Y1 * Z1) * 2
    return (x3, y3, z3)


def _jac_mixed_add(acc, x2, y2):
    """(jacobian) + (affine) on an a = 0 curve; returns jacobian."""
    X1, Y1, Z1 = acc
    if Z1.is_zero():
        return (x2, y2, type(x2).ONE)
    z1z1 = Z1.square()
    u2 = x2 * z1z1
    s2 = y2 * Z1 * z1z1
    h = u2 - X1
    r = s2 - Y1
    if h.is_zero():
        if r.is_zero():
            return _jac_double(X1, Y1, Z1)
        return (type(x2).ONE, type(x2).ONE, type(x2).ZERO)
    hh = h.square()
    i = hh + hh
    i = i + i
    j = h * i
    r = r + r
    v = X1 * i
    x3 = r.square() - j - v - v
    yj = Y1 * j
    y3 = r * (v - x3) - yj - yj
    z3 = (Z1 + h).square() - z1z1 - hh
    return (x3, y3, z3)


class CurvePoint:
    """Affine point (or infinity) on y^2 = x^3 + b over a generic field.

    Affine representation keeps the golden model dead simple; performance-
    critical batched arithmetic lives on the TPU side in Jacobian form.
    """

    __slots__ = ("x", "y", "inf", "b")

    def __init__(self, x, y, b, inf=False):
        self.x, self.y, self.b, self.inf = x, y, b, inf

    @classmethod
    def infinity(cls, b):
        return cls(None, None, b, inf=True)

    def __eq__(self, o):
        if self.inf or o.inf:
            return self.inf and o.inf
        return self.x == o.x and self.y == o.y

    def __repr__(self):
        return "Inf" if self.inf else f"({self.x}, {self.y})"

    def is_on_curve(self):
        if self.inf:
            return True
        return self.y.square() == self.x.square() * self.x + self.b

    def __neg__(self):
        if self.inf:
            return self
        return CurvePoint(self.x, -self.y, self.b)

    def __add__(self, o):
        if self.inf:
            return o
        if o.inf:
            return self
        if self.x == o.x:
            if self.y == o.y:
                return self.double()
            return CurvePoint.infinity(self.b)
        lam = (o.y - self.y) * (o.x - self.x).inverse()
        x3 = lam.square() - self.x - o.x
        y3 = lam * (self.x - x3) - self.y
        return CurvePoint(x3, y3, self.b)

    def __sub__(self, o):
        return self + (-o)

    def double(self):
        if self.inf or self.y.is_zero():
            return CurvePoint.infinity(self.b)
        lam = (self.x.square() * 3) * (self.y + self.y).inverse()
        x3 = lam.square() - self.x - self.x
        y3 = lam * (self.x - x3) - self.y
        return CurvePoint(x3, y3, self.b)

    def mul(self, k: int):
        return self.mul_raw(k % R)

    def mul_raw(self, k: int):
        """Scalar multiply WITHOUT reducing k mod the group order.

        mul() assumes r-order points (the normal case); subgroup checks
        (is r*P == inf?) need the unreduced ladder or the test is
        vacuous.

        Jacobian ladder with ONE field inversion at the end: the affine
        double-and-add paid ~2 modular inversions per bit (~12 ms per
        256-bit scalar mul), which dominated the verifier's IC combination
        and the prover's host finishing."""
        if self.inf or k == 0:
            return CurvePoint.infinity(self.b)
        if type(self.x) is Fq:
            out = _jac_mul_fq(self.x.v, self.y.v, k)
            if out is None:
                return CurvePoint.infinity(self.b)
            return CurvePoint(Fq(out[0]), Fq(out[1]), self.b)
        if type(self.x) is Fq2:
            out = _jac_mul_fq2(
                (self.x.c0, self.x.c1), (self.y.c0, self.y.c1), k
            )
            if out is None:
                return CurvePoint.infinity(self.b)
            return CurvePoint(Fq2(*out[0]), Fq2(*out[1]), self.b)
        one = type(self.x).ONE
        x2, y2 = self.x, self.y              # fixed affine addend
        acc = None                           # jacobian accumulator
        for bit in bin(k)[2:]:               # MSB-first
            if acc is not None:
                acc = _jac_double(*acc)
            if bit == "1":
                if acc is None:
                    acc = (x2, y2, one)
                else:
                    acc = _jac_mixed_add(acc, x2, y2)
        if acc is None or acc[2].is_zero():
            return CurvePoint.infinity(self.b)
        X1, Y1, Z1 = acc
        zinv = Z1.inverse()
        zinv2 = zinv.square()
        return CurvePoint(X1 * zinv2, Y1 * zinv2 * zinv, self.b)

    __mul__ = mul
    __rmul__ = mul


# curve coefficients
B_G1 = Fq(G1_B)
B_G2 = Fq2(G1_B, 0) * XI_FQ2.inverse()  # b' = b / xi  (D-type twist)


def g1_generator() -> CurvePoint:
    return CurvePoint(Fq(G1_GEN[0]), Fq(G1_GEN[1]), B_G1)


def g2_generator() -> CurvePoint:
    return CurvePoint(Fq2(*G2_GEN_X), Fq2(*G2_GEN_Y), B_G2)


def g1_point(x: int, y: int) -> CurvePoint:
    return CurvePoint(Fq(x), Fq(y), B_G1)


def g1_infinity() -> CurvePoint:
    return CurvePoint.infinity(B_G1)


def g2_infinity() -> CurvePoint:
    return CurvePoint.infinity(B_G2)


# ---------------------------------------------------------------------------
# Embedding into E(Fq12) for the pairing (untwist map)
# ---------------------------------------------------------------------------

# w^2 = v in Fq6 coords: w2 = (0, 1, 0) as Fq6, embedded at c0 of Fq12
_W2 = Fq12(Fq6(Fq2.ZERO, Fq2.ONE, Fq2.ZERO), Fq6.ZERO)         # w^2
_W3 = Fq12(Fq6.ZERO, Fq6(Fq2.ZERO, Fq2.ONE, Fq2.ZERO))         # w^3
B_FQ12 = Fq12(Fq6(Fq2(G1_B, 0), Fq2.ZERO, Fq2.ZERO), Fq6.ZERO)


def fq2_to_fq12(a: Fq2) -> Fq12:
    return Fq12(Fq6(a, Fq2.ZERO, Fq2.ZERO), Fq6.ZERO)


def fq_to_fq12(a: Fq) -> Fq12:
    return fq2_to_fq12(Fq2(a.v, 0))


def untwist(p: CurvePoint) -> CurvePoint:
    """psi: E'(Fq2) -> E(Fq12), (x', y') -> (x' w^2, y' w^3).

    (y' w^3)^2 = y'^2 xi w^... : since w^6 = xi, psi lands on y^2 = x^3 + b.
    """
    if p.inf:
        return CurvePoint.infinity(B_FQ12)
    return CurvePoint(fq2_to_fq12(p.x) * _W2, fq2_to_fq12(p.y) * _W3, B_FQ12)


def g1_to_fq12(p: CurvePoint) -> CurvePoint:
    if p.inf:
        return CurvePoint.infinity(B_FQ12)
    return CurvePoint(fq_to_fq12(p.x), fq_to_fq12(p.y), B_FQ12)
