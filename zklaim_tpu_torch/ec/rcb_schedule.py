"""The complete doubling and add as warp schedules: what kernel msm_finish
(csrc/curve.cu) runs, and the add alone, what kernel msm_tails runs.

The MSM finish is one dependent chain of 256 doublings and 32 adds a sum.
The kernel spreads the independent Fq products of ONE point operation over
the threads of a warp.  Threads that ran different straight-line code would
diverge, so the formulas are data: a schedule is a list of steps; in a step
every taking-part thread reads two slots of a small file of Fq elements in
shared memory, applies its opcode (mul, add, sub) and writes one slot; all
reads of a step come before its writes.  A step holds either products or
additions and subtractions, never both, so all threads of a product step run
the same code.

This module writes the two formulas (the dataflow of curve.point_double and
curve.point_add; over Fq2 every product is the schoolbook's four Fq products,
which need no sums before and one level of combining after, where
Karatsuba's three need a level before and two after: a step costs the same
whether 18 or 24 threads multiply, so the chain is what counts) as a graph
of Fq operations, cuts it into steps (list scheduling by the
length of the chain behind each operation, so a round's products share a
step), gives every value a slot (a slot is reused once its last
reader has run), and packs the result for the kernel.  `interpret` runs a
schedule on Python integers as the kernel runs it on the card; the CPU
tests hold it against the plain formulas.  Every Fq operation returns the
canonical residue, so the order of operations does not change a limb.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from ..ff.params import MONT_R, Q
from .hostcurve import B_G2

MUL, ADD, SUB = 0, 1, 2
IDLE = 0xFF
# header words of the packed schedule (csrc/curve.cu reads the same offsets)
HDR_G, HDR_NS, HDR_NCONST, HDR_SDBL, HDR_SADD, HDR_ACC, HDR_Q, HDR_WORDS = 0, 1, 2, 3, 4, 5, 11, 17

ACC = ("X", "Y", "Z")
ADDEND = ("QX", "QY", "QZ")


def group_size(deg: int) -> int:
    """Threads that take part: the six products of an add's round, four
    Fq products each over Fq2."""
    return 6 if deg == 1 else 24


def comps(deg: int, v: str) -> list:
    """Names of the Fq components of a curve-field value."""
    return [v] if deg == 1 else [v + ".0", v + ".1"]


class _Graph:
    """Fq operations (op, dst, a, b) in single assignment, written at the
    level of the curve's field."""

    def __init__(self, deg: int):
        self.deg = deg
        self.ops = []

    def lin(self, op: int, dst: str, a: str, b: str) -> None:
        for d_, a_, b_ in zip(comps(self.deg, dst), comps(self.deg, a), comps(self.deg, b)):
            self.ops.append((op, d_, a_, b_))

    def add(self, dst, a, b):
        self.lin(ADD, dst, a, b)

    def sub(self, dst, a, b):
        self.lin(SUB, dst, a, b)

    def dbl(self, dst, a):
        self.lin(ADD, dst, a, a)

    def mul(self, dst: str, a: str, b: str) -> None:
        if self.deg == 1:
            self.ops.append((MUL, dst, a, b))
            return
        # schoolbook over Fq[u] / (u^2 + 1): c0 = a0 b0 - a1 b1, c1 = a0 b1 + a1 b0
        self.ops += [
            (MUL, dst + ".t0", a + ".0", b + ".0"),
            (MUL, dst + ".t1", a + ".1", b + ".1"),
            (MUL, dst + ".t2", a + ".0", b + ".1"),
            (MUL, dst + ".t3", a + ".1", b + ".0"),
            (SUB, dst + ".0", dst + ".t0", dst + ".t1"),
            (ADD, dst + ".1", dst + ".t2", dst + ".t3"),
        ]

    def mul_b3(self, dst: str, x: str) -> None:
        """3b x: over Fq 9x = 2(2(2x)) + x, over Fq2 a product by 3b'."""
        if self.deg == 2:
            self.mul(dst, x, "B3")
            return
        self.dbl(dst + ".2", x)
        self.dbl(dst + ".4", dst + ".2")
        self.dbl(dst + ".8", dst + ".4")
        self.add(dst, dst + ".8", x)

    def mul_b9(self, dst: str, x: str, b3x: str) -> None:
        """9b x, given b3x = 3b x: over Fq 2 b3x + b3x, over Fq2 a second
        constant product, which rides in the step of the first."""
        if self.deg == 2:
            self.mul(dst, x, "B9")
            return
        self.dbl(dst + ".2", b3x)
        self.add(dst, dst + ".2", b3x)


def double_graph(deg: int) -> _Graph:
    """(X, Y, Z) -> (X', Y', Z') = 2 (X, Y, Z): curve.point_double."""
    g = _Graph(deg)
    g.mul("t0", "Y", "Y")
    g.mul("t1", "Y", "Z")
    g.mul("t2", "Z", "Z")
    g.mul("t3", "X", "Y")
    g.dbl("a2", "t0")
    g.dbl("a4", "a2")
    g.dbl("z8", "a4")                     # 8 Y^2
    g.mul_b3("nb", "t2")                  # 3b Z^2
    g.mul_b9("n3", "t2", "nb")             # 9b Z^2
    g.sub("t0m", "t0", "n3")
    g.add("t0p", "t0", "nb")
    g.mul("Z'", "t1", "z8")
    g.mul("q1", "nb", "z8")
    g.mul("q2", "t0m", "t0p")
    g.mul("q3", "t0m", "t3")
    g.add("Y'", "q2", "q1")
    g.dbl("X'", "q3")
    return g


def add_graph(deg: int) -> _Graph:
    """(X, Y, Z), (QX, QY, QZ) -> (X', Y', Z') = their sum: curve.point_add."""
    g = _Graph(deg)
    for s, (a, b) in enumerate((("X", "Y"), ("QX", "QY"), ("Y", "Z"), ("QY", "QZ"),
                                ("X", "Z"), ("QX", "QZ"))):
        g.add(f"s{s}", a, b)
    g.mul("t0", "X", "QX")
    g.mul("t1", "Y", "QY")
    g.mul("t2", "Z", "QZ")
    g.mul("m0", "s0", "s1")
    g.mul("m1", "s2", "s3")
    g.mul("m2", "s4", "s5")
    g.add("u01", "t0", "t1")
    g.add("u12", "t1", "t2")
    g.add("u02", "t0", "t2")
    g.sub("t3", "m0", "u01")
    g.sub("t4", "m1", "u12")
    g.sub("t5", "m2", "u02")
    g.dbl("d0", "t0")
    g.add("m", "d0", "t0")                # 3 X1 X2
    g.mul_b3("nb", "t2")
    g.mul_b3("bv", "t5")
    g.sub("wmn", "t1", "nb")
    g.add("wpn", "t1", "nb")
    g.mul("p0", "t3", "wmn")
    g.mul("p1", "t4", "bv")
    g.mul("p2", "wpn", "wmn")
    g.mul("p3", "m", "bv")
    g.mul("p4", "t4", "wpn")
    g.mul("p5", "t3", "m")
    g.sub("X'", "p0", "p1")
    g.add("Y'", "p2", "p3")
    g.add("Z'", "p4", "p5")
    return g


MUL_COST = 9      # a product step against a linear one, roughly, on the card


def cut_into_steps(ops: list, given: set, width: int) -> list:
    """Ops in dependency order -> steps of at most `width` ops, each all
    products or all linear.  List scheduling: a step takes the kind of the
    ready op with the longest chain still behind it (a product counted as
    MUL_COST linear ops), then every ready op of that kind, longest chain
    first.  A product so waits for the linear ops that feed its round's
    other products, and the products of one round share a step."""
    readers = {}
    for o in ops:
        for src in {o[2], o[3]}:
            readers.setdefault(src, []).append(o)
    chain = {}
    for o in reversed(ops):
        cost = MUL_COST if o[0] == MUL else 1
        chain[o[1]] = cost + max((chain[r[1]] for r in readers.get(o[1], [])), default=0)
    done, left, steps = set(given), list(ops), []
    while left:
        ready = sorted((o for o in left if o[2] in done and o[3] in done),
                       key=lambda o: -chain[o[1]])
        if not ready:
            raise ValueError("operation graph has an operand nobody computes")
        step = [o for o in ready if (o[0] == MUL) == (ready[0][0] == MUL)][:width]
        steps.append(step)
        done.update(o[1] for o in step)
        left = [o for o in left if o not in step]
    return steps


def assign_slots(steps: list, pinned: dict, first_free: int) -> tuple:
    """Name-level steps -> (slot-level steps, slots used).  `pinned` maps the
    inputs and constants to their slots; an output X' takes X's slot (every
    reader of X must have run by then, reads of the same step included).  Any
    other value takes a free slot, and frees it after its last reader."""
    last_read = {}
    for s, step in enumerate(steps):
        for _, _, a, b in step:
            last_read[a] = last_read[b] = s
    slot, free, high = dict(pinned), [], first_free
    out = []
    for s, step in enumerate(steps):
        for name in [n for n, at in last_read.items() if at == s and n in slot and n not in pinned]:
            free.append(slot[name])            # read in this step at the latest: writable now
        row = []
        for op, d, a, b in step:
            old = d.replace("'", "")
            if old != d and old in pinned:          # X' or, over Fq2, X'.0 and X'.1
                if last_read.get(old, -1) > s:
                    raise ValueError(f"{d} would overwrite {old} before its last reader")
                slot[d] = pinned[old]
            elif free:
                slot[d] = free.pop()
            else:
                slot[d], high = high, high + 1
            row.append((op, slot[d], slot[a], slot[b]))
        out.append(row)
    return out, high


def _mont(x: int) -> int:
    return x * MONT_R % Q


def _schedule(deg: int, with_double: bool) -> dict:
    """The add, and the doubling where asked, of one group for a kernel: `g`
    threads, `slots` slots, `consts` {slot: Montgomery-form integer} (3b',
    with the doubling 9b', and acc = infinity), the pinned slots of acc and
    the addend, and the two step lists [(op, dst, a, b), ...] on slots (the
    doubling's empty without it)."""
    names = [c for v in ACC + ADDEND for c in comps(deg, v)]
    pinned = {n: i for i, n in enumerate(names)}
    consts = {}
    if deg == 2:
        b3, b9 = B_G2 * 3, B_G2 * 9
        values = [("B3.0", b3.c0), ("B3.1", b3.c1)]
        if with_double:
            values += [("B9.0", b9.c0), ("B9.1", b9.c1)]
        for n, v in values:
            pinned[n] = len(pinned)
            consts[pinned[n]] = _mont(v)
    for n in comps(deg, "X") + comps(deg, "Z") + comps(deg, "Y")[1:]:
        consts[pinned[n]] = 0                                  # acc = (0, 1, 0)
    consts[pinned[comps(deg, "Y")[0]]] = _mont(1)
    g = group_size(deg)
    given = set(pinned)
    dbl, n1 = [], len(pinned)
    if with_double:
        dbl, n1 = assign_slots(cut_into_steps(double_graph(deg).ops, given, g), pinned, len(pinned))
    add, n2 = assign_slots(cut_into_steps(add_graph(deg).ops, given, g), pinned, len(pinned))
    slots = max(n1, n2)
    if slots >= IDLE:
        raise ValueError(f"{slots} slots do not fit a byte")
    return {"deg": deg, "g": g, "slots": slots, "consts": consts,
            "acc": [pinned[c] for v in ACC for c in comps(deg, v)],
            "addend": [pinned[c] for v in ADDEND for c in comps(deg, v)],
            "double": dbl, "add": add}


@lru_cache(maxsize=None)
def finish_schedule(deg: int) -> dict:
    """The doubling and the add, as kernel msm_finish runs them."""
    return _schedule(deg, with_double=True)


@lru_cache(maxsize=None)
def tails_schedule(deg: int) -> dict:
    """The add alone, as kernel msm_tails runs it: acc = infinity from the
    constants, then one add a set bit of the lane's prefix length."""
    return _schedule(deg, with_double=False)


def pack(sched: dict) -> np.ndarray:
    """A schedule as the uint32 words the kernel reads: the header, the
    constants (slot, 8 little-endian words each), then each step as one word
    a thread: a | b << 8 | dst << 16 | op << 24, dst = IDLE for a thread
    that sits the step out."""
    g = sched["g"]
    words = [0] * HDR_WORDS
    words[HDR_G], words[HDR_NS], words[HDR_NCONST] = g, sched["slots"], len(sched["consts"])
    words[HDR_SDBL], words[HDR_SADD] = len(sched["double"]), len(sched["add"])
    for base, key in ((HDR_ACC, "acc"), (HDR_Q, "addend")):
        words[base : base + len(sched[key])] = sched[key]
    for slot, value in sorted(sched["consts"].items()):
        words += [slot] + [(value >> (32 * j)) & 0xFFFFFFFF for j in range(8)]
    for step in sched["double"] + sched["add"]:
        if len({op == MUL for op, *_ in step}) != 1 or len(step) > g:
            raise ValueError("a step mixes products with linear operations, or is too wide")
        words += [a | b << 8 | d << 16 | op << 24 for op, d, a, b in step]
        words += [IDLE << 16] * (g - len(step))
    return np.array(words, dtype=np.uint32)


def interpret(steps: list, file: dict) -> None:
    """Run slot-level steps on a file {slot: Montgomery-form integer} in
    place, as the kernel does: every read of a step before any write."""
    rinv = pow(MONT_R, -1, Q)
    for step in steps:
        results = []
        for op, d, a, b in step:
            x, y = file[a], file[b]
            results.append((d, x * y * rinv % Q if op == MUL else
                            (x + y) % Q if op == ADD else (x - y) % Q))
        file.update(results)


def interpret_finish(sched: dict, tot: list, head: list, c: int, k: int) -> list:
    """The two phases of kernel msm_finish on Python integers.  tot, head:
    for each of the k W window lanes the 3 deg Montgomery-form components of
    the partial; returns the components of the k sums.  Window w of sum i is
    lane i W + w."""
    deg, W = sched["deg"], len(tot) // k
    window = []
    for t, h in zip(tot, head):                               # phase A
        file = dict(sched["consts"])
        file.update(zip(sched["acc"], t))
        for _ in range(c - 1):
            interpret(sched["double"], file)
        minus_h = [(-v) % Q if j // deg == 1 else v for j, v in enumerate(h)]
        file.update(zip(sched["addend"], minus_h))
        interpret(sched["add"], file)
        window.append([file[s] for s in sched["acc"]])
    sums = []
    for i in range(k):                                        # phase B
        file = dict(sched["consts"])                          # acc = infinity
        for w in range(W - 1, -1, -1):
            for _ in range(c):
                interpret(sched["double"], file)
            file.update(zip(sched["addend"], window[i * W + w]))
            interpret(sched["add"], file)
        sums.append([file[s] for s in sched["acc"]])
    return sums


def _brev64(x: int) -> int:
    """The 64 bits of x in reverse order (CUDA's __brevll)."""
    return int(format(x & (2**64 - 1), "064b")[::-1], 2)


def tail_walk(m: int, nb: int) -> list:
    """The (level, column) reads of one tail lane with prefix length m in a
    flat batch of 2^nb lanes, in the order kernel msm_tails makes them: for
    each set bit t of m, lowest first (bits above nb are no level), the
    column rev_{nb-t}(clamp((m >> t) - 1, 0, 2^(nb-t) - 1)) of level t, the
    reversal done as the kernel does it, __brevll and a shift."""
    bits, reads = m & ((1 << (nb + 1)) - 1), []
    while bits:
        t = (bits & -bits).bit_length() - 1
        nat = min(max((m >> t) - 1, 0), (1 << (nb - t)) - 1)
        reads.append((t, _brev64(nat) >> (64 - (nb - t)) if nb > t else nat))
        bits &= bits - 1
    return reads


def interpret_tails(sched: dict, levels: list, m: list, nb: int) -> list:
    """Kernel msm_tails on Python integers.  levels[t][col]: the 3 deg
    Montgomery-form components of column col of upsweep level t; m: the
    prefix length of each tail lane.  Returns each lane's components."""
    out = []
    for mi in m:
        file = dict(sched["consts"])                          # acc = infinity
        for t, col in tail_walk(mi, nb):
            file.update(zip(sched["addend"], levels[t][col]))
            interpret(sched["add"], file)
        out.append([file[s] for s in sched["acc"]])
    return out
