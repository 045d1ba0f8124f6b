"""R1CS constraint-system builder (protoboard equivalent).

TPU-native replacement for libsnark gadgetlib1's `protoboard`,
`pb_variable`, `pb_linear_combination` and `r1cs_constraint_system`
(used by the reference at zklaim/zklaim_gadget.cpp:154-360 and
zklaim/snark.cpp:82-87; SURVEY.md §2.6 row 7).

Differences from libsnark, by design:
  - Constraints are built host-side in Python (circuit construction is
    cold-path); the artifacts handed to the device are flat COO arrays
    (row, col, Montgomery-coefficient limbs) per matrix, statically
    padded -- the shape XLA wants for the QAP instance/witness maps
    (segment-sum sparse matvec, see groth16/).
  - Witness generation is a list of per-gadget hooks run in allocation
    order against a flat integer witness vector; gadget hooks are free
    to vectorize internally (numpy) since they only touch the vector.

Variable convention (libsnark-compatible): index 0 is the constant ONE;
indices 1..num_primary are the public (primary) input; the rest are
auxiliary.  A constraint is <A,w> * <B,w> = <C,w>.

Jax-free copy of zklaim_tpu/r1cs/system.py: the code is identical and only the
imports differ (..ff.limbs is this package's numpy/torch limb module,
..ff.params is this package's copy of the constants), so the port imports without jax.
"""

from __future__ import annotations

import numpy as np

from ..ff.limbs import NUM_LIMBS, ints_to_limbs
from ..ff.params import R


class LC:
    """Sparse linear combination over Fr: {var_index: coeff}."""

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
        return self + (o * (R - 1))

    def __mul__(self, k: int):
        k %= R
        if k == 0:
            return LC()
        return LC({v: (c * k) % R for v, c in self.terms.items()})

    __rmul__ = __mul__
    __radd__ = __add__

    def __neg__(self):
        return self * (R - 1)

    def eval(self, w) -> int:
        return sum(c * int(w[v]) for v, c in self.terms.items()) % R


ONE = LC.of(0)
ZERO = LC()


def bit_operand(lc: LC):
    """Canonicalize a boolean-valued LC to (var, negated) if possible.

    Recognized forms: const 0/1 (var 0 with/without negation -- w[0] == 1
    makes ONE just var 0), single var {v: 1}, negated var {0: 1, v: R-1}.
    Returns None for anything else (caller falls back to a python hook).
    """
    t = lc.terms
    if not t:
        return (0, True)                     # const 0 == NOT w[0]
    if len(t) == 1:
        (v, c), = t.items()
        if c == 1:
            return (v, False)
        return None
    if len(t) == 2 and t.get(0) == 1:
        (v, c), = ((v, c) for v, c in t.items() if v != 0)
        if c == R - 1:
            return (v, True)
    return None


def signed_terms(lc: LC, bound: int):
    """LC terms as [(var, signed_int)] + const, mapping c > R/2 to c - R.

    Returns None unless every |signed coefficient| (and the const)
    is <= bound -- the caller's guarantee that i64 evaluation with
    bit-valued inputs cannot overflow."""
    terms, const = [], 0
    for v, c in lc.terms.items():
        s = c if c <= R // 2 else c - R
        if abs(s) > bound:
            return None
        if v == 0:
            const = s
        else:
            terms.append((v, s))
    return terms, const


class WitnessVec:
    """Witness assignment: numpy int64 fast lane + dict of big values.

    Behaves like the list[int] the slow path returns (len/iter/index);
    values >= 2^62 (packed public inputs, field inverses) live in `big`."""

    __slots__ = ("small", "big")
    _BIG = 1 << 62

    def __init__(self, num_vars: int):
        self.small = np.zeros(num_vars, dtype=np.int64)
        self.big: dict[int, int] = {}

    def __len__(self):
        return self.small.shape[0]

    def __getitem__(self, i):
        if isinstance(i, slice):
            big = self.big
            return [
                big.get(j, int(self.small[j]))
                for j in range(*i.indices(len(self)))
            ]
        v = self.big.get(i)
        if v is not None:
            return v
        return int(self.small[i])

    def __setitem__(self, i, v):
        v = int(v)
        if 0 <= v < self._BIG:
            self.small[i] = v
        else:
            self.big[i] = v % R

    def __iter__(self):
        big = self.big
        for i, v in enumerate(self.small.tolist()):
            yield big.get(i, v)

    def to_plain_limbs(self) -> np.ndarray:
        """(num_vars, 16) u32 plain-domain limb array, vectorized."""
        from ..ff.limbs import LIMB_BITS, LIMB_MASK, NUM_LIMBS, int_to_limbs

        out = np.zeros((len(self), NUM_LIMBS), dtype=np.uint32)
        u = self.small.astype(np.uint64)
        for i in range(4):                   # i64 values span limbs 0..3
            out[:, i] = (u >> np.uint64(LIMB_BITS * i)) & np.uint64(LIMB_MASK)
        for v, x in self.big.items():
            out[v] = int_to_limbs(x)
        return out


class WitnessPlan:
    """Level-scheduled, batched witness evaluator.

    Hooks are grouped into dependency levels (level = 1 + max level of
    any input variable) and, within a level, into same-kind batches that
    evaluate as single numpy array ops.  Replaces the reference's
    sequential per-gadget witness generation (zklaim_gadget.cpp:705-783)
    with data-parallel passes; descriptors are registered by the gadget
    library (gadgets/bits.py) alongside the python closures."""

    def __init__(self, cs: "ConstraintSystem"):
        lvl = np.zeros(cs.num_vars, dtype=np.int64)
        buckets: dict[tuple, list] = {}
        for idx, desc in enumerate(cs.hook_descs):
            if desc is None:
                raise ValueError("hook without descriptor; no plan possible")
            kind = desc[0]
            if kind == "bitop":
                _, op, ins, out = desc
                in_vars = [v for v, _ in ins]
                outs = [out]
                key = (op, len(ins))
            elif kind == "dec":
                _, terms, _c, first, n = desc
                in_vars = [v for v, _ in terms]
                outs = list(range(first, first + n))
                key = ("dec", n)
            elif kind == "py":
                _, in_vars, outs = desc
                key = ("py",)
            else:
                raise ValueError(f"unknown descriptor {kind}")
            level = 1 + int(lvl[in_vars].max()) if in_vars else 1
            lvl[outs] = level
            buckets.setdefault((level,) + key, []).append(idx)

        self._batches = []
        for key in sorted(buckets, key=lambda k: k[0]):
            idxs = buckets[key]
            kind = key[1]
            if kind == "py":
                self._batches.append(("py", [cs.hooks[i] for i in idxs]))
            elif kind == "dec":
                n = key[2]
                descs = [cs.hook_descs[i] for i in idxs]
                counts = [len(d[1]) for d in descs]
                if min(counts) == 0:         # reduceat needs non-empty rows
                    self._batches.append(("py", [cs.hooks[i] for i in idxs]))
                    continue
                cat_v = np.array(
                    [v for d in descs for v, _ in d[1]], dtype=np.int64
                )
                cat_c = np.array(
                    [c for d in descs for _, c in d[1]], dtype=np.int64
                )
                starts = np.zeros(len(descs), dtype=np.int64)
                np.cumsum(counts[:-1], out=starts[1:])
                consts = np.array([d[2] for d in descs], dtype=np.int64)
                firsts = np.array([d[3] for d in descs], dtype=np.int64)
                self._batches.append(
                    ("dec", n, cat_v, cat_c, starts, consts, firsts)
                )
            else:                            # bitop
                descs = [cs.hook_descs[i] for i in idxs]
                in_var = np.array(
                    [[v for v, _ in d[2]] for d in descs], dtype=np.int64
                )
                in_neg = np.array(
                    [[neg for _, neg in d[2]] for d in descs], dtype=bool
                )
                out_var = np.array([d[3] for d in descs], dtype=np.int64)
                self._batches.append(("bitop", kind, in_var, in_neg, out_var))

        self.num_vars = cs.num_vars

    def run(self, w: WitnessVec) -> None:
        small = w.small
        for batch in self._batches:
            tag = batch[0]
            if tag == "py":
                for fn in batch[1]:
                    fn(w)
            elif tag == "dec":
                _, n, cat_v, cat_c, starts, consts, firsts = batch
                prods = small[cat_v] * cat_c
                vals = np.add.reduceat(prods, starts) + consts
                shifts = np.arange(n, dtype=np.int64)
                bits = (vals[:, None] >> shifts) & 1
                idx = firsts[:, None] + shifts
                small[idx.reshape(-1)] = bits.reshape(-1)
            else:
                _, op, in_var, in_neg, out_var = batch
                vv = small[in_var]
                vv = np.where(in_neg, 1 - vv, vv)
                if op == "xor":
                    r = vv[:, 0] ^ vv[:, 1]
                elif op == "and":
                    r = vv[:, 0] & vv[:, 1]
                elif op == "ch":
                    e, f_, g = vv[:, 0], vv[:, 1], vv[:, 2]
                    r = g ^ (e & (f_ ^ g))
                else:                        # maj
                    a, b, c = vv[:, 0], vv[:, 1], vv[:, 2]
                    r = (a & b) | (a & c) | (b & c)
                small[out_var] = r


class ConstraintSystem:
    """R1CS builder + witness-hook registry."""

    def __init__(self):
        self.num_vars = 1          # var 0 == ONE
        self.num_primary = 0       # set by mark_primary_end()
        self.constraints: list[tuple[LC, LC, LC]] = []
        self.hooks: list = []      # callables hook(w: list[int]) -> None
        self.hook_descs: list = [] # parallel typed descriptors (or None)
        self.annotations: list[str] = []
        self._plan = None

    # -- allocation -------------------------------------------------------

    def alloc(self, n: int = 1):
        """Allocate n variables; returns first index (or index if n == 1)."""
        first = self.num_vars
        self.num_vars += n
        return first

    def alloc_lc(self):
        return LC.of(self.alloc())

    def mark_primary_end(self):
        """All variables allocated so far (except ONE) are primary inputs."""
        self.num_primary = self.num_vars - 1

    # -- constraints ------------------------------------------------------

    def constrain(self, a: LC, b: LC, c: LC, note: str = ""):
        self.constraints.append((a, b, c))
        self.annotations.append(note)

    def enforce_boolean(self, lc: LC, note: str = "bool"):
        """lc * (1 - lc) = 0."""
        self.constrain(lc, ONE - lc, ZERO, note)

    def enforce_equal(self, a: LC, b: LC, note: str = "eq"):
        """(a - b) * 1 = 0."""
        self.constrain(a - b, ONE, ZERO, note)

    # -- witness ----------------------------------------------------------

    def add_hook(self, fn, desc=None):
        self.hooks.append(fn)
        self.hook_descs.append(desc)
        self._plan = None

    def witness_plan(self):
        """Compiled batched evaluator; None if any hook lacks a descriptor
        (or hooks were manipulated directly, desyncing the descriptors)."""
        if len(self.hooks) != len(self.hook_descs):
            return None
        if self._plan is None:
            try:
                self._plan = WitnessPlan(self)
            except ValueError:
                self._plan = False
        return self._plan or None

    def generate_witness(self, init_hook=None, fast=True):
        """Full assignment [1, ...]: WitnessVec (fast) or list[int].

        init_hook, if given, runs first (sets external inputs).  The fast
        path level-schedules typed hook batches into vectorized numpy
        passes (see WitnessPlan) and is value-identical to the sequential
        hook run; fast=False forces the sequential reference path.
        """
        plan = self.witness_plan() if fast else None
        if plan is not None:
            w = WitnessVec(self.num_vars)
            w.small[0] = 1
            if init_hook is not None:
                init_hook(w)
            plan.run(w)
            return w
        w = [0] * self.num_vars
        w[0] = 1
        if init_hook is not None:
            init_hook(w)
        for h in self.hooks:
            h(w)
        return w

    def is_satisfied(self, w) -> bool:
        for i, (a, b, c) in enumerate(self.constraints):
            if a.eval(w) * b.eval(w) % R != c.eval(w):
                return False
        return True

    def first_unsatisfied(self, w):
        """Index + annotation of the first failing constraint (debugging)."""
        for i, (a, b, c) in enumerate(self.constraints):
            if a.eval(w) * b.eval(w) % R != c.eval(w):
                return i, self.annotations[i]
        return None

    # -- export for the device (Groth16 setup/prove) ----------------------

    def to_coo(self):
        """Three COO matrices as numpy arrays, rows sorted.

        Returns dict m -> (rows i32, cols i32, coeffs int list) for
        m in 'A','B','C'.  Coefficients are plain ints mod r; the
        Groth16 layer converts to Montgomery limbs / domain as needed.
        """
        out = {}
        for name, k in (("A", 0), ("B", 1), ("C", 2)):
            rows, cols, coeffs = [], [], []
            for i, con in enumerate(self.constraints):
                for v, c in sorted(con[k].terms.items()):
                    rows.append(i)
                    cols.append(v)
                    coeffs.append(c)
            out[name] = (
                np.asarray(rows, dtype=np.int32),
                np.asarray(cols, dtype=np.int32),
                coeffs,
            )
        return out

    @property
    def num_constraints(self):
        return len(self.constraints)
