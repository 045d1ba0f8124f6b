"""n-bit comparison gadget: (less, less_or_eq) flags for a vs b.

TPU-native replacement for libsnark gadgetlib1's comparison_gadget (the
reference instantiates width-64 comparisons per attribute slot at
zklaim/zklaim_gadget.cpp:371,499-539; SURVEY.md §2.3 item "Comparison
machinery").

Method: decompose diff = 2^n + b - a into n+1 bits (requires
a, b < 2^n).  The top bit equals [a <= b]; the low n bits are nonzero
iff a != b (in both branches), detected with the s*inv == z trick; then
less = less_or_eq AND nonzero.  Cost: n+6 constraints.

Jax-free copy of zklaim_tpu/gadgets/compare.py: the code is identical and only the
imports differ (..ff.limbs is this package's numpy/torch limb module,
..ff.params is this package's copy of the constants), so the port imports without jax.
"""

from __future__ import annotations

from ..ff.params import R
from ..r1cs.system import LC, ONE, ZERO, ConstraintSystem
from .bits import decompose, pack_lc


def comparison(cs: ConstraintSystem, n: int, a: LC, b: LC, note="cmp"):
    """Returns (less, less_or_eq) bit LCs with less = [a < b], le = [a <= b].

    Caller guarantees 0 <= value(a), value(b) < 2^n.
    """
    diff = LC.const(1 << n) + b - a
    bits = decompose(cs, diff, n + 1, note + ".diff")
    le = bits[n]

    # z = [low bits != 0] == [a != b]
    s = pack_lc(bits[:n])
    z = cs.alloc_lc()
    inv = cs.alloc_lc()
    cs.constrain(s, inv, z, note + ".z")
    cs.constrain(s, ONE - z, ZERO, note + ".z0")
    z_var = next(iter(z.terms))
    inv_var = next(iter(inv.terms))

    def hook(w, s=s, z_var=z_var, inv_var=inv_var):
        v = s.eval(w)
        w[inv_var] = pow(v, -1, R) if v else 0
        w[z_var] = 1 if v else 0

    cs.add_hook(
        hook, ("py", sorted(v for v in s.terms if v), [z_var, inv_var])
    )

    less = cs.alloc_lc()
    cs.constrain(le, z, less, note + ".less")
    less_var = next(iter(less.terms))

    def hook2(w, le=le, z_var=z_var, less_var=less_var):
        w[less_var] = le.eval(w) & int(w[z_var])

    cs.add_hook(
        hook2,
        ("py", sorted({v for v in le.terms if v} | {z_var}), [less_var]),
    )
    return less, le
