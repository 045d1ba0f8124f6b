"""The port's jax-free circuit-layer copies against the originals.

zklaim_tpu_torch.{r1cs.system, gadgets.*, claims.circuit} are copies of
the JAX package's modules with only their imports changed; here they must
build the same constraint system (COO, variable counts) and the same
witness as the originals, for ZKlaimCircuit(1), ZKlaimCircuit(2) and the
small circuit.
"""

import difflib
import hashlib
from pathlib import Path

import numpy as np
import pytest

import __graft_entry__ as GE
from zklaim_tpu.claims import circuit as JCirc

from zklaim_tpu_torch import entry
from zklaim_tpu_torch.claims import circuit as TCirc

ROOT = Path(__file__).resolve().parent.parent
COPIES = ["r1cs/system.py", "gadgets/bits.py", "gadgets/compare.py",
          "gadgets/sha256.py", "claims/circuit.py"]


def _same_system(a, b):
    assert (a.num_vars, a.num_primary, a.num_constraints) == (
        b.num_vars, b.num_primary, b.num_constraints)
    ca, cb = a.to_coo(), b.to_coo()
    for name in "ABC":
        np.testing.assert_array_equal(ca[name][0], cb[name][0])
        np.testing.assert_array_equal(ca[name][1], cb[name][1])
        assert ca[name][2] == cb[name][2]


@pytest.mark.parametrize("path", COPIES)
def test_copies_differ_only_in_imports_and_docstring(path):
    old = (ROOT / "zklaim_tpu" / path).read_text().splitlines()
    new = (ROOT / "zklaim_tpu_torch" / path).read_text().splitlines()
    changed = [l[1:] for l in difflib.unified_diff(old, new, lineterm="", n=0)
               if l[:1] in "+-" and not l.startswith(("+++", "---"))]
    code = [l for l in changed if l.strip() and not l.startswith(
        ("Jax-free copy", "imports differ", "..ff.params is"))]
    assert all("import" in l for l in code), code


def _payload(seed):
    pre = hashlib.sha256(bytes([seed])).digest() + bytes(16)
    refs = [int.from_bytes(pre[8 * k : 8 * k + 8], "little") + 1 for k in range(5)]
    ops = [JCirc.OP_LESS, JCirc.OP_LESS_EQ, JCirc.OP_NOOP, JCirc.OP_NOT_EQ, JCirc.OP_NOOP]
    return pre, refs, ops


def _make_pre(attrs, salt=0xDEADBEEF00C0FFEE):
    return b"".join(int(v).to_bytes(8, "little") for v in list(attrs) + [salt])


def _two_payloads():
    """The two payloads of tests/test_zklaim_circuit.py:test_two_payloads."""
    return [
        (_make_pre([25, 40000, 7, 7, 1]), [18, 50000, 7, 9, 99],
         [JCirc.OP_GREATER_EQ, JCirc.OP_LESS, JCirc.OP_EQ, JCirc.OP_NOT_EQ, JCirc.OP_NOOP]),
        (_make_pre([100, 200, 300, 400, 500]), [100, 100, 400, 400, 0],
         [JCirc.OP_EQ, JCirc.OP_GREATER, JCirc.OP_LESS, JCirc.OP_LESS_EQ, JCirc.OP_NOOP]),
    ]


@pytest.mark.parametrize("num_payloads, counts", [(1, (25412, 6, 27629)),
                                                  (2, (50822, 11, 55257))])
def test_credential_circuit_matches_original(num_payloads, counts):
    """Variables, primary inputs and constraints grow with the payload count
    (N = 20, the reference benchmark's MAX_PL, runs on the card only)."""
    old, new = JCirc.ZKlaimCircuit(num_payloads), TCirc.ZKlaimCircuit(num_payloads)
    _same_system(old.cs, new.cs)
    assert (old.cs.num_vars, old.cs.num_primary, old.cs.num_constraints) == counts
    inputs = [_payload(3)] if num_payloads == 1 else _two_payloads()
    wo, wn = old.witness(inputs), new.witness(inputs)
    np.testing.assert_array_equal(wo.to_plain_limbs(), wn.to_plain_limbs())
    assert list(wo) == list(wn)
    assert new.cs.is_satisfied(wn), new.cs.first_unsatisfied(wn)
    assert old.public_inputs(inputs) == new.public_inputs(inputs)
    assert [wn[v] for v in new.packed_vars] == new.public_inputs(inputs)
    hashed = [(hashlib.sha256(pre).digest(), refs, ops) for pre, refs, ops in inputs]
    assert TCirc.public_inputs_for(hashed) == new.public_inputs(inputs)


def test_tiny_circuit_matches_graft_entry():
    (cs_o, w_o), (cs_n, w_n) = GE._tiny_circuit(), entry.tiny_circuit()
    _same_system(cs_o, cs_n)
    assert list(w_o) == list(w_n)
    assert cs_n.is_satisfied(w_n)
