"""Several holders proving at once in one process, on the CPU: four threads,
each a copy.deepcopy of one warm holder of the zero-payload credential,
prove two claims each; every proof is the one a single holder gives for
the same claim and rng, byte for byte, and verifies.  The copies share the
pk import and the circuit, the recorder keeps each thread's spans apart
and counts the proofs in flight, and utils.device_cache makes a constant
whole before it is cached.

On the CPU an MSM's plain version costs about 20 s a proof even at N = 0
(its bucket tails and finish step through thousands of small torch ops),
so the prover's five sums are computed here on the host's exact integers
(`_host_sums`): every other stage of the proof, the context and its caches
run as they do in a service.  The card test (test_torch_holders_cuda.py)
runs the whole path, kernels included, on four CUDA streams.
"""

import copy
import random
import threading

import pytest

import torch

from zklaim_tpu_torch.claims import signing
from zklaim_tpu_torch.claims.api import ZKLAIM_OK, Context
from zklaim_tpu_torch.ec import curve as C
from zklaim_tpu_torch.ec.hostcurve import g1_generator, g2_generator
from zklaim_tpu_torch.ff.limbs import limbs_to_ints
from zklaim_tpu_torch.groth16 import api as G
from zklaim_tpu_torch.utils import device_cache
from zklaim_tpu_torch.utils.profiling import recording

torch.set_num_threads(1)

HOLDERS, CLAIMS = 4, 2


def _host_sums(pk, w_plain, h, msm_c=8):
    """groth16.api.prove_sums on Python integers: the same five sums as
    planes ((3, 16, 4) G1 of A, B1, H, L; (6, 16, 1) G2 of B2)."""
    aux = w_plain[pk.num_primary + 1:]

    def total(deg, rows, scalars):
        gen = g1_generator() if deg == 1 else g2_generator()
        acc = gen.infinity(gen.b)
        if len(rows):
            points = C.planes_to_host_points(deg, C.rows_to_planes(rows))
            for p, s in zip(points, limbs_to_ints(scalars.numpy())):
                acc = acc + p * s
        return acc

    def planes(deg, points):
        f = C.ops_for(deg)
        return C.point_to_planes(f, C.host_points_to_proj(f, points, w_plain.device))

    g1 = [total(1, pk.a_g1, w_plain), total(1, pk.b_g1, w_plain), total(1, pk.h_g1, h),
          total(1, pk.l_g1, aux)]
    return planes(1, g1), planes(2, [total(2, pk.b_g2, w_plain)])


@pytest.fixture(scope="module")
def holder():
    """A warm holder of the zero-payload credential (it has proved once, so
    it holds the imported pk and the built circuit) and the proofs a single
    holder gives for claims 0 ... 7 (rng random.Random(claim))."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(G, "prove_sums", _host_sums)
        rng = random.Random(18)
        issuer = Context("cpu")
        assert issuer.trusted_setup(rng) == ZKLAIM_OK
        assert issuer.sign(signing.keygen(rng), rng) == ZKLAIM_OK
        ctx = Context("cpu")
        ctx.pk, ctx.vk = issuer.pk, issuer.vk
        ctx.pub_key, ctx.signature = issuer.pub_key, issuer.signature
        assert ctx.proof_generate(random.Random(-1)) == ZKLAIM_OK
        serial = []
        for claim in range(HOLDERS * CLAIMS):
            assert ctx.proof_generate(random.Random(claim)) == ZKLAIM_OK
            serial.append(ctx.proof)
        yield ctx, serial


def test_four_holders_on_four_threads_give_a_single_holders_proofs(holder, monkeypatch):
    ctx, serial = holder
    monkeypatch.setattr(G, "prove_sums", _host_sums)
    proofs, copies, errors = {}, [], []
    start = threading.Barrier(HOLDERS, timeout=60)

    def serve(t):
        try:
            mine = copy.deepcopy(ctx)
            copies.append(mine)
            start.wait()
            for claim in range(t * CLAIMS, (t + 1) * CLAIMS):
                assert mine.proof_generate(random.Random(claim)) == ZKLAIM_OK
                proofs[claim] = mine.proof
                assert mine.verify() == ZKLAIM_OK
        except BaseException as exc:                 # reported by the main thread
            errors.append(exc)

    with recording() as rec:
        threads = [threading.Thread(target=serve, args=(t,)) for t in range(HOLDERS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and errors == []
    assert [proofs[claim] for claim in range(HOLDERS * CLAIMS)] == serial
    assert len(set(serial)) == len(serial)                     # fresh r, s a proof
    for mine in copies:                                        # one pk import, one circuit
        assert mine._pk_cache is ctx._pk_cache and mine._circuit_cache is ctx._circuit_cache
        assert mine.device == "cpu"

    # the recorder: each span's parent opened on the span's own thread, each
    # thread's proofs and no span of the pk import or circuit (warm copies)
    assert len(set(rec.threads)) == HOLDERS and len(rec.threads) == len(rec.spans)
    assert all(end is not None for _, end, _, _ in rec.spans)
    assert all(rec.threads[parent] == rec.threads[i]
               for i, (_, _, _, parent) in enumerate(rec.spans) if parent >= 0)
    names = [name for _, _, name, _ in rec.spans]
    assert names.count("claims.proof_generate") == HOLDERS * CLAIMS
    assert "claims.pk_import" not in names and "claims.circuit" not in names
    in_flight = [n for _, name, n in rec.counts if name == "claims.in_flight"]
    assert len(in_flight) == HOLDERS * CLAIMS and all(1 <= n <= HOLDERS for n in in_flight)


def test_a_device_constant_is_made_whole_before_it_is_cached(monkeypatch):
    """The value is made, the making stream synchronised, then cached: a
    later caller on any stream gets it without a wait; on the CPU there is
    no stream to wait for.  clear() makes the next caller make it anew."""
    made, waits = [], []

    class Stream:
        def synchronize(self):
            waits.append(len(made))

    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream())
    monkeypatch.setattr(device_cache, "_CACHES", [])         # clear() forgets this one only

    @device_cache.device_constant
    def table(n, device):
        made.append((n, device))
        return object()

    first = table(3, "cuda:0")
    assert made == [(3, "cuda:0")] and waits == [1]
    assert table(3, "cuda:0") is first and waits == [1]
    table(3, "cpu")
    assert made[-1] == (3, "cpu") and waits == [1]
    device_cache.clear()
    assert table(3, "cuda:0") is not first and waits == [1, 3]
    assert device_cache._CACHES == [table]
