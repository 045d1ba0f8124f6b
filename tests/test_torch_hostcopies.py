"""The port's own copies of the host modules against the originals.

zklaim_tpu_torch imports nothing of zklaim_tpu, so it keeps copies of the
host field/curve/pairing modules, of the issuer's signing module, of
the native-library binding and of the legacy package (three host modules
verbatim; the PoC circuit and the credential model, whose relative imports
reach the port's circuit, gadgets and claims.api).  Each copy may differ from its original only
in import lines and inside the module docstring; and the two pairing
checks must agree on a valid and on an invalid Groth16 product.
"""

import ast
import difflib
import random
from pathlib import Path

import pytest

from zklaim_tpu.ec import hostcurve as JH
from zklaim_tpu.ec import pairing as JP

from zklaim_tpu_torch.ec import hostcurve as TH
from zklaim_tpu_torch.ec import pairing as TP
from zklaim_tpu_torch.ff.params import R

ROOT = Path(__file__).resolve().parent.parent
COPIES = ["ff/params.py", "ff/hostfield.py", "ff/fq12flat.py", "ec/hostcurve.py",
          "ec/pairing.py", "claims/signing.py", "utils/native.py",
          "legacy/lamport.py", "legacy/merkle.py", "legacy/ecdsa_secp256k1.py",
          "legacy/poc_circuit.py", "legacy/cred.py"]


def _docstring_lines(source: str) -> int:
    """Number of leading lines up to the end of the module docstring."""
    first = ast.parse(source).body[0]
    assert isinstance(first, ast.Expr) and isinstance(first.value.value, str)
    return first.end_lineno


@pytest.mark.parametrize("path", COPIES)
def test_copy_differs_only_in_imports_and_docstring(path):
    old = (ROOT / "zklaim_tpu" / path).read_text()
    new = (ROOT / "zklaim_tpu_torch" / path).read_text()
    old_body = old.splitlines()[_docstring_lines(old):]
    new_body = new.splitlines()[_docstring_lines(new):]
    changed = [l[1:] for l in difflib.unified_diff(old_body, new_body, lineterm="", n=0)
               if l[:1] in "+-" and not l.startswith(("+++", "---"))]
    code = [l for l in changed if l.strip()]
    assert all("import" in l for l in code), code
    assert new != old            # the copy says in its docstring that it is one


def _groth16_like_product(H, a, b, c, d):
    """(-aG1, bG2), (cG1, dG2), (G1, (ab - cd)G2): product one iff consistent."""
    g1, g2 = H.g1_generator(), H.g2_generator()
    return [(-(g1 * a), g2 * b), (g1 * c, g2 * d), (g1, g2 * ((a * b - c * d) % R))]


@pytest.mark.parametrize("valid", [True, False], ids=["valid", "invalid"])
def test_pairing_product_agrees_with_original(valid):
    rnd = random.Random(21)
    a, b, c, d = (rnd.randrange(1, R) for _ in range(4))
    old = _groth16_like_product(JH, a, b, c, d)
    new = _groth16_like_product(TH, a, b, c, d)
    if not valid:
        old[1] = (old[1][0] + JH.g1_generator(), old[1][1])
        new[1] = (new[1][0] + TH.g1_generator(), new[1][1])
    assert JP.pairing_product_is_one(old) is valid
    assert TP.pairing_product_is_one(new) is valid
