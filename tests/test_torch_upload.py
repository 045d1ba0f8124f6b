"""groth16.api.upload_witness, the prover's upload, against the host limb
array it replaced (`to_tensor(witness_plain_limbs(w))`): limb for limb on a
synthetic WitnessVec (the edges of the int64 lane, big values, a big index
over a stale small slot), on a ZKlaimCircuit(1) witness and on the list[int]
form, and the bytes it counts as sent (groth16.upload_bytes).
"""

import random

import numpy as np
import pytest

import torch

from zklaim_tpu_torch.claims.circuit import ZKlaimCircuit
from zklaim_tpu_torch.claims.witness import witness_program
from zklaim_tpu_torch.ff.limbs import to_tensor
from zklaim_tpu_torch.ff.params import R
from zklaim_tpu_torch.groth16 import api as G
from zklaim_tpu_torch.r1cs.system import WitnessVec
from zklaim_tpu_torch.utils.profiling import recording

torch.set_num_threads(1)

SMALL = [0, 1, (1 << 16) - 1, 1 << 16, 1 << 32, (1 << 48) - 1, (1 << 62) - 1]
PACKED = int.from_bytes(bytes(range(1, 32)), "little") % R      # a packed public input


def _synthetic() -> WitnessVec:
    """The lane's edges, then big values (2^62, R - 1, a packed input), one
    of them over a slot whose small value was left stale."""
    w = WitnessVec(len(SMALL) + 5)
    for i, v in enumerate(SMALL):
        w[i] = v
    base = len(SMALL)
    w[base] = 1 << 62
    w[base + 1] = R - 1
    w[base + 2] = PACKED
    w.small[base + 3] = 12345                  # stale: the big value below overwrites it
    w[base + 3] = (1 << 200) + 7
    w[base + 4] = 99
    return w


@pytest.fixture(scope="module")
def circuit_witness():
    circuit = ZKlaimCircuit(1)
    rng = random.Random(21)
    attrs = [rng.randrange(1 << 20, 1 << 40) for _ in range(5)]
    pre = b"".join(v.to_bytes(8, "little") for v in attrs) + rng.randbytes(8)
    return witness_program(circuit).witness([(pre, attrs, [0, 1, 2, 3, 4])])


def _want(w) -> torch.Tensor:
    return to_tensor(G.witness_plain_limbs(w), "cpu")


def _counted(w):
    with recording() as rec:
        got = G.upload_witness(w, "cpu")
    return got, [n for _, name, n in rec.counts if name == "groth16.upload_bytes"]


def test_synthetic_witness_limb_for_limb():
    w = _synthetic()
    assert w.small[len(SMALL) + 3] == 12345 and len(w.big) == 4
    got = G.upload_witness(w, "cpu")
    assert got.dtype == torch.int32 and got.shape == (len(w), 16)
    assert torch.equal(got, _want(w))
    assert G.witness_plain_limbs(w)[len(SMALL) + 3, 0] == 7


def test_circuit_witness_limb_for_limb(circuit_witness):
    w = circuit_witness
    assert isinstance(w, WitnessVec) and w.big
    assert torch.equal(G.upload_witness(w, "cpu"), _want(w))


@pytest.mark.parametrize("form", ["synthetic", "circuit"])
def test_list_form_gives_the_same_limbs(circuit_witness, form):
    w = _synthetic() if form == "synthetic" else circuit_witness
    assert torch.equal(G.upload_witness(list(w), "cpu"), _want(w))


@pytest.mark.parametrize("form", ["synthetic", "circuit"])
def test_upload_counts_the_bytes_it_sends(circuit_witness, form):
    """The int64 lane and 72 B a big row (index and limbs); a list sends
    its 16 int32 limbs a variable."""
    w = _synthetic() if form == "synthetic" else circuit_witness
    got, sent = _counted(w)
    assert sent == [len(w) * 8 + len(w.big) * 72]
    got_list, sent_list = _counted(list(w))
    assert sent_list == [len(w) * 64]
    assert torch.equal(got, got_list)


def test_upload_leaves_the_witness_as_it_was():
    w = _synthetic()
    small, big = w.small.copy(), dict(w.big)
    G.upload_witness(w, "cpu")
    np.testing.assert_array_equal(w.small, small)
    assert w.big == big
