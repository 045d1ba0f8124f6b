"""One seed, identical key bytes in both packages, through the credential
API: the zero-payload Context.trusted_setup(random.Random(7)) of the JAX
package and of the port (on the CPU) give equal pk and vk bytes, and
leave the caller's rng in the same state.
"""

import random

import torch

from zklaim_tpu.claims import api as JAPI

from zklaim_tpu_torch.claims import api as TAPI

# The suite runs as several worker processes on a few cores; torch's
# intra-op threads would only contend with them.
torch.set_num_threads(1)


def test_zero_payload_trusted_setup_bytes_equal():
    r_jax, r_port = random.Random(7), random.Random(7)
    theirs, ours = JAPI.Context(), TAPI.Context("cpu")
    assert theirs.trusted_setup(r_jax) == JAPI.ZKLAIM_OK
    assert ours.trusted_setup(r_port) == TAPI.ZKLAIM_OK
    assert ours.vk == theirs.vk
    assert ours.pk == theirs.pk
    assert len(ours.pk) == 20 + 3 * 64 + 2 * 128 + 64 * 2 + 128
    assert r_jax.random() == r_port.random()
