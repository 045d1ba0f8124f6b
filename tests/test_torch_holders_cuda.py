"""Several holders proving at once on the card (needs CUDA): a proving
service's shape, one process, the issuer's pk imported once, holders that
are copies of one context, each proving on its own thread and CUDA stream.

Run on a machine with an NVIDIA GPU (no jax needed there, hence
--noconftest):

    python -m pytest --noconftest -m cuda tests/test_torch_holders_cuda.py

Each test skips inside the `issued` fixture when no card is present.  The
credential holds one payload (ZKlaimCircuit(1), m = 2^15); claim k is the
same attributes under references k + 1 above them, proved with rng
random.Random(100 + k).  Every proof is compared byte for byte with the one
a single holder gives on the default stream.
"""

import copy
import random
import threading

import pytest

import torch

from zklaim_tpu_torch import kernels as K
from zklaim_tpu_torch.claims import signing
from zklaim_tpu_torch.claims.api import ZKLAIM_OK, Context, Payload, ZkOp
from zklaim_tpu_torch.utils import device_cache

pytestmark = pytest.mark.cuda

HOLDERS, CLAIMS = 4, 2
ATTRS = [1 << 20, 3 << 21, 5 << 22, 7 << 23, 9 << 24]


def _claim(ctx: Context, k: int) -> None:
    """Claim k on the context's one payload: each attribute < attribute + k + 1."""
    pl = ctx.payloads[0]
    pl.data_ref = [a + k + 1 for a in ATTRS]
    pl.data_op = [ZkOp.LESS] * 5


def _serve(holders: list, work) -> None:
    """work(t, holder) on thread t for each holder, the threads started
    together; raises the first exception a thread raised."""
    errors = []
    start = threading.Barrier(len(holders), timeout=120)

    def run(t, holder):
        try:
            start.wait()
            work(t, holder)
        except BaseException as exc:                 # raised again by the main thread
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(t, h)) for t, h in enumerate(holders)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]


@pytest.fixture(scope="module")
def issued():
    """(a cold holder: the pk's bytes, no import yet; a warm holder that has
    proved; the single holder's proofs of claims 0 ... 7, default stream)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    K.library()
    dev = torch.device("cuda:0")
    rng = random.Random(18)
    issuer = Context(dev)
    pl = Payload()
    for pos, a in enumerate(ATTRS):
        pl.set_attr(a, pos)
    issuer.add_payload(pl)
    issuer.hash_payloads(rng)
    assert issuer.trusted_setup(rng) == ZKLAIM_OK
    assert issuer.sign(signing.keygen(rng), rng) == ZKLAIM_OK
    cold = copy.deepcopy(issuer)
    cold._pk_cache = None                              # imports the pk at its first proof
    warm = copy.deepcopy(cold)
    serial = []
    for k in range(HOLDERS * CLAIMS):
        _claim(warm, k)
        assert warm.proof_generate(random.Random(100 + k)) == ZKLAIM_OK
        serial.append(warm.proof)
    assert warm.verify() == ZKLAIM_OK
    torch.cuda.synchronize()
    return cold, warm, serial


def test_four_cold_holders_on_four_streams_give_the_serial_proofs(issued):
    """The device constants forgotten, four copies of a holder that has not
    imported the pk start at once, each on its own stream: each imports the
    pk and makes the constants it misses there (twiddles, schedules, the
    infinity row, 1 in Montgomery form), and proves two claims; every proof
    is the serial one, byte for byte."""
    cold, _, serial = issued
    device_cache.clear()
    holders = [copy.deepcopy(cold) for _ in range(HOLDERS)]
    proofs = {}

    def work(t, holder):
        stream = torch.cuda.Stream()
        with torch.cuda.stream(stream):
            for k in range(t * CLAIMS, (t + 1) * CLAIMS):
                _claim(holder, k)
                assert holder.proof_generate(random.Random(100 + k)) == ZKLAIM_OK
                proofs[k] = holder.proof
        stream.synchronize()

    _serve(holders, work)
    assert [proofs[k] for k in range(HOLDERS * CLAIMS)] == serial


def test_four_warm_copies_share_one_pk_and_count_every_launch(issued):
    """Copies of a warm holder hold the very tables of its pk import (one
    copy on the card: equal data_ptr, nothing allocated by the copies), and
    four proofs at once on four streams count four times a lone proof's
    launches, kernel by kernel."""
    _, warm, serial = issued
    before = dict(K.LAUNCHES)
    _claim(warm, 0)
    assert warm.proof_generate(random.Random(100)) == ZKLAIM_OK
    lone = {k: v - before[k] for k, v in K.LAUNCHES.items() if v != before[k]}
    assert lone["msm_upsweep"] > 0 and warm.proof == serial[0]

    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated()
    holders = [copy.deepcopy(warm) for _ in range(HOLDERS)]
    assert torch.cuda.memory_allocated() == allocated
    pk = warm._pk_cache[2]
    for h in holders:
        mine = h._pk_cache[2]
        for table in ("a_g1", "b_g1", "b_g2", "h_g1", "l_g1"):
            assert getattr(mine, table).data_ptr() == getattr(pk, table).data_ptr()
        assert h._pk_cache[3] is warm._pk_cache[3]                # the QAP and its domain
    proofs = {}

    def work(t, holder):
        stream = torch.cuda.Stream()
        with torch.cuda.stream(stream):
            _claim(holder, t)
            assert holder.proof_generate(random.Random(100 + t)) == ZKLAIM_OK
            proofs[t] = holder.proof
        stream.synchronize()

    before = dict(K.LAUNCHES)
    _serve(holders, work)
    assert {k: v - before[k] for k, v in K.LAUNCHES.items() if v != before[k]} == {
        k: HOLDERS * n for k, n in lone.items()}
    assert [proofs[t] for t in range(HOLDERS)] == serial[:HOLDERS]


def test_a_holder_works_on_its_own_stream_only(issued):
    """A copy proves on its own stream while the default stream is busy (a
    spin of about a second): the proof returns before the spin ends, so it
    neither synchronised the device nor waited on the default stream; and
    every kernel and copy of the proof ran on one stream, not the default
    stream's (the profiler's stream of each activity on the card)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _, warm, serial = issued
    holder = copy.deepcopy(warm)
    stream = torch.cuda.Stream()
    _claim(holder, 5)
    with torch.cuda.stream(stream):                     # warm this stream's memory pool
        assert holder.proof_generate(random.Random(100 + 5)) == ZKLAIM_OK
    stream.synchronize()

    spun = torch.cuda.Event()
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)                    # about 1 s at 1.98 GHz, default stream
    spun.record()
    with torch.cuda.stream(stream):
        assert holder.proof_generate(random.Random(100 + 5)) == ZKLAIM_OK
    stream.synchronize()
    assert not spun.query() and holder.proof == serial[5]
    torch.cuda.synchronize()

    marker = torch.ones(1, device="cuda:0")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        marker.add_(1)                                  # one kernel on the default stream
        torch.cuda.synchronize()
        with torch.cuda.stream(stream):
            assert holder.proof_generate(random.Random(100 + 5)) == ZKLAIM_OK
        stream.synchronize()
    events = sorted((e.start_ns(), e.device_resource_id()) for e in
                    prof.profiler.kineto_results.events() if e.device_type() == DeviceType.CUDA)
    default, proof = events[0][1], {rid for _, rid in events[1:]}
    assert len(events) > 100 and len(proof) == 1 and default not in proof
    assert holder.proof == serial[5]
