"""ZKlaimCircuit(N)'s constraints and its QAP at tau, on Python integers.

The layout of zklaim's predicate circuit (zklaim/zklaim_gadget.cpp) as the
port lays it out, frozen here for the benchmark's reference: per payload
384 preimage bits, 512 reference bits and 512 op bits (each a boolean
variable), one SHA256 compression of the padded preimage (message schedule,
64 rounds, the IV added), a 64-bit comparison per attribute slot with the
op-gated predicate rows and the one-hot row, and at the end the packing of
every public bit into 253-bit primary inputs.  Variable 0 is the constant
one, 1..k the primary inputs.  Only the constraints are built: the
reference needs no witness.

`column_evals` is the QAP's instance map for chosen wires: A_j(tau),
B_j(tau), C_j(tau) over the Lagrange basis of the m-th roots of unity, with
the input-consistency rows n + i (wire i in A, i = 0..k) after the n
constraints, as libsnark's r1cs_to_qap puts them.
"""

from __future__ import annotations

from .bn254.params import FR_CAPACITY, R, ROOT_OF_UNITY, TWO_ADICITY

BITS_PER_PAYLOAD = 256 + 512 + 512
NUM_SLOTS = 5
OP_LESS, OP_LESS_EQ, OP_EQ, OP_GREATER_EQ, OP_GREATER, OP_NOT_EQ, OP_NOOP = range(7)
SHA256_IV = [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
             0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19]
SHA256_K = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1, 0x923F82A4,
    0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3, 0x72BE5D74, 0x80DEB1FE,
    0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F,
    0x4A7484AA, 0x5CB0A9DC, 0x76F988DA, 0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7,
    0xC6E00BF3, 0xD5A79147, 0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC,
    0x53380D13, 0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070, 0x19A4C116,
    0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F, 0x682E6FF3,
    0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208, 0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7,
    0xC67178F2,
]
# zklaim's padding of a 48-byte message: 0x80, zeros, the 64-bit length 384
PADDING = bytes([0x80] + [0] * 13 + [0x01, 0x80])


class LC:
    """A linear combination over Fr: {wire: coefficient}, no zero entries."""

    __slots__ = ("terms",)

    def __init__(self, terms=None):
        self.terms = dict(terms) if terms else {}

    @classmethod
    def of(cls, var: int, coeff: int = 1):
        return cls({var: coeff % R})

    @classmethod
    def const(cls, c: int):
        return cls({0: c % R}) if c % R else cls()

    def __add__(self, o):
        if isinstance(o, int):
            o = LC.const(o)
        t = dict(self.terms)
        for v, c in o.terms.items():
            nc = (t.get(v, 0) + c) % R
            if nc:
                t[v] = nc
            else:
                t.pop(v, None)
        return LC(t)

    def __sub__(self, o):
        if isinstance(o, int):
            o = LC.const(o)
        return self + o * (R - 1)

    def __mul__(self, k: int):
        k %= R
        return LC({v: c * k % R for v, c in self.terms.items()}) if k else LC()

    __rmul__ = __mul__


ONE, ZERO = LC.of(0), LC()


class System:
    """Wires and rows <A, w> * <B, w> = <C, w>, in the order they are made."""

    def __init__(self):
        self.num_vars = 1
        self.num_primary = 0
        self.rows = []

    def alloc(self, n: int = 1) -> int:
        first = self.num_vars
        self.num_vars += n
        return first

    def row(self, a: LC, b: LC, c: LC):
        self.rows.append((a.terms, b.terms, c.terms))

    def boolean(self, x: LC):
        self.row(x, ONE - x, ZERO)

    def equal(self, a: LC, b: LC):
        self.row(a - b, ONE, ZERO)


def _const_of(x: LC):
    if not x.terms:
        return 0
    if len(x.terms) == 1 and 0 in x.terms:
        return x.terms[0]
    return None


def _bit(cs: System) -> LC:
    b = LC.of(cs.alloc())
    cs.boolean(b)
    return b


def pack(bits) -> LC:
    s = LC()
    for i, b in enumerate(bits):
        s = s + b * (1 << i)
    return s


def decompose(cs: System, x: LC, n: int) -> list:
    """n boolean wires, little-endian, that sum to x: n + 1 rows."""
    first = cs.alloc(n)
    bits = [LC.of(first + i) for i in range(n)]
    for b in bits:
        cs.boolean(b)
    cs.row(pack(bits) - x, ONE, ZERO)
    return bits


def xor(cs: System, a: LC, b: LC) -> LC:
    ca, cb = _const_of(a), _const_of(b)
    if ca is not None:
        return b if ca == 0 else ONE - b
    if cb is not None:
        return a if cb == 0 else ONE - a
    c = LC.of(cs.alloc())
    cs.row(a * 2, b, a + b - c)
    return c


def ch(cs: System, e: LC, f: LC, g: LC) -> LC:
    ce = _const_of(e)
    if ce is not None:
        return f if ce else g
    if _const_of(f) is not None and _const_of(f) == _const_of(g):
        return f
    c = LC.of(cs.alloc())
    cs.row(e, f - g, c - g)
    return c


def maj(cs: System, a: LC, b: LC, c: LC) -> LC:
    consts = [_const_of(x) for x in (a, b, c)]
    if consts.count(None) <= 1:
        known = [v for v in consts if v is not None]
        if sum(known) >= 2:
            return ONE
        if len(known) == 3 or (len(known) == 2 and sum(known) == 0):
            return ZERO if sum(known) < 2 else ONE
        (unknown,) = [x for x, v in zip((a, b, c), consts) if v is None]
        if sum(known) == 1:
            return unknown
    t = a + b + c
    m = LC.of(cs.alloc())
    cs.boolean(m)
    cs.row(t - m * 2, ONE - t + m * 2, ZERO)
    return m


def comparison(cs: System, n: int, a: LC, b: LC) -> tuple:
    """(less, less_or_eq) of a against b, both below 2^n: n + 6 rows."""
    bits = decompose(cs, LC.const(1 << n) + b - a, n + 1)
    le = bits[n]
    s = pack(bits[:n])
    z, inv = LC.of(cs.alloc()), LC.of(cs.alloc())
    cs.row(s, inv, z)
    cs.row(s, ONE - z, ZERO)
    less = LC.of(cs.alloc())
    cs.row(le, z, less)
    return less, le


def _words(bits_msb: list) -> list:
    return [[bits_msb[32 * t + 31 - i] for i in range(32)] for t in range(len(bits_msb) // 32)]


def _rotr(w, k):
    return [w[(i + k) % 32] for i in range(32)]


def _shr(w, k):
    return [w[i + k] if i + k < 32 else LC.const(0) for i in range(32)]


def _xor3(cs, a, b, c):
    return [xor(cs, xor(cs, a[i], b[i]), c[i]) for i in range(32)]


def _add(cs, lcs, const=0):
    total = LC.const(const)
    for x in lcs:
        total = total + x
    return decompose(cs, total, 35)[:32]


def sha256(cs: System, block_msb: list) -> list:
    """One compression of a 512-bit block from the standard IV: 256 bits."""
    W = _words(block_msb)
    for t in range(16, 64):
        s0 = _xor3(cs, _rotr(W[t - 15], 7), _rotr(W[t - 15], 18), _shr(W[t - 15], 3))
        s1 = _xor3(cs, _rotr(W[t - 2], 17), _rotr(W[t - 2], 19), _shr(W[t - 2], 10))
        W.append(_add(cs, [pack(s1), pack(W[t - 7]), pack(s0), pack(W[t - 16])]))
    a, b, c, d, e, f, g, h = [[LC.const((v >> i) & 1) for i in range(32)] for v in SHA256_IV]
    for t in range(64):
        S1 = _xor3(cs, _rotr(e, 6), _rotr(e, 11), _rotr(e, 25))
        chw = [ch(cs, e[i], f[i], g[i]) for i in range(32)]
        S0 = _xor3(cs, _rotr(a, 2), _rotr(a, 13), _rotr(a, 22))
        mw = [maj(cs, a[i], b[i], c[i]) for i in range(32)]
        t1 = [pack(h), pack(S1), pack(chw), pack(W[t])]
        new_e = _add(cs, [pack(d)] + t1, SHA256_K[t])
        new_a = _add(cs, t1 + [pack(S0), pack(mw)], SHA256_K[t])
        h, g, f, e = g, f, e, new_e
        d, c, b, a = c, b, a, new_a
    out = []
    for iv, reg in zip(SHA256_IV, (a, b, c, d, e, f, g, h)):
        word = _add(cs, [pack(reg)], iv)
        out.extend(word[31 - i] for i in range(32))
    return out


def _u64_le(bits, byte_offset: int) -> LC:
    s = LC()
    for b in range(8):
        for i in range(8):
            s = s + bits[(byte_offset + b) * 8 + i] * (1 << (8 * b + 7 - i))
    return s


def _byte(bits, byte_offset: int) -> LC:
    s = LC()
    for i in range(8):
        s = s + bits[byte_offset * 8 + i] * (1 << (7 - i))
    return s


def circuit(num_payloads: int) -> System:
    """The constraints of ZKlaimCircuit(num_payloads)."""
    cs = System()
    n_chunks = -(-BITS_PER_PAYLOAD * num_payloads // FR_CAPACITY)
    first = cs.alloc(n_chunks)
    cs.num_primary = cs.num_vars - 1
    public = []
    for _ in range(num_payloads):
        pre, refs, ops = ([_bit(cs) for _ in range(n)] for n in (384, 512, 512))
        pad = [LC.const((byte >> i) & 1) for byte in PADDING for i in range(7, -1, -1)]
        public += sha256(cs, pre + pad) + refs + ops
        for k in range(NUM_SLOTS):
            less, le = comparison(cs, 64, _u64_le(pre, 8 * k), _u64_le(refs, 8 * k))
            o = [_byte(ops, 8 * k + j) for j in range(7)]
            cs.row(o[OP_LESS], less, o[OP_LESS])
            cs.row(o[OP_LESS_EQ], le, o[OP_LESS_EQ])
            cs.row(o[OP_EQ], le, o[OP_EQ])
            cs.row(o[OP_EQ], ONE - less, o[OP_EQ])
            cs.row(o[OP_GREATER_EQ], ONE - less, o[OP_GREATER_EQ])
            cs.row(o[OP_GREATER], ONE - le, o[OP_GREATER])
            cs.row(o[OP_NOT_EQ], less + (ONE - le), o[OP_NOT_EQ])
            cs.row(o[OP_NOOP], ONE, o[OP_NOOP])
            total = LC()
            for j in range(7):
                total = total + o[j]
            cs.equal(total, ONE)
    for c in range(n_chunks):
        cs.row(pack(public[c * FR_CAPACITY : (c + 1) * FR_CAPACITY]) - LC.of(first + c),
               ONE, ZERO)
    return cs


def domain_size(cs: System) -> int:
    """m: the power of two that holds the rows and the consistency rows."""
    return 1 << (len(cs.rows) + cs.num_primary).bit_length()


def column_evals(cs: System, tau: int, wires) -> tuple:
    """({wire: A(tau)}, {wire: B(tau)}, {wire: C(tau)}, Z(tau)) for `wires`."""
    n, k, m = len(cs.rows), cs.num_primary, domain_size(cs)
    omega = pow(ROOT_OF_UNITY, 1 << (TWO_ADICITY - (m.bit_length() - 1)), R)
    z_tau = (pow(tau, m, R) - 1) % R
    powers = [1] * (n + k + 1)
    for j in range(1, n + k + 1):
        powers[j] = powers[j - 1] * omega % R
    denoms = [m * (tau - w) % R for w in powers]
    prefix = [1]
    for d in denoms:
        prefix.append(prefix[-1] * d % R)
    inv = pow(prefix[-1], -1, R)
    lagrange = [0] * len(denoms)
    for j in range(len(denoms) - 1, -1, -1):
        lagrange[j] = z_tau * powers[j] % R * (prefix[j] * inv % R) % R
        inv = inv * denoms[j] % R
    wanted = set(wires)
    sums = tuple({j: 0 for j in wanted} for _ in range(3))
    for row, lj in zip(cs.rows, lagrange):
        for acc, terms in zip(sums, row):
            for j in terms.keys() & wanted:
                acc[j] += terms[j] * lj
    for i in range(k + 1):                           # the input-consistency rows
        if i in wanted:
            sums[0][i] += lagrange[n + i]
    return tuple({j: v % R for j, v in s.items()} for s in sums) + (z_tau,)
