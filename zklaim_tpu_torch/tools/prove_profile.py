"""Phase-level timing of the Groth16 prover on the credential circuit.

Counterpart of tools/prove_profile.py, with its phase names: witness build,
witness limbs -> device, h_pipeline (witness map + NTTs), each of the five
MSMs alone, device -> host decode; then h_pipeline again, split into the
spans that groth16.api.h_plain and QAP.h_coefficients open, each closed
with a synchronise (utils.profiling.recording(sync=device)): a row a span,
its self time, in the order the spans close.  Every mark synchronises the
device too, so a phase's time is its own.  Before the repetitions it
times what a fresh holder pays once on the host (circuit build,
QAP.for_cs, the proving key's import from bytes); after them, the prover
as groth16.api.prove runs it (the four G1 sums as one msm_many, no
synchronisation between the sums), and the verifier.

    python -m zklaim_tpu_torch.tools.prove_profile [--payloads N] [--reps R] [--device cpu]

With ZKLAIM_TRACE_DIR set, each of those proves is traced (utils.profiling),
and its marks then include the profiler's cost.
"""

from __future__ import annotations

import argparse
import random
import time

import torch

from .. import resolve_device
from ..utils.profiling import card_label, device_trace, recording, sync


class Marks:
    """Named wall-clock marks, each taken after a synchronise of the device."""

    def __init__(self, device):
        self.device, self.label = device, card_label(device)
        self.rows = []
        self.last = self.start = time.perf_counter()

    def restart(self) -> None:
        sync(self.device)
        self.last = self.start = time.perf_counter()

    def mark(self, name: str, group: str = "") -> None:
        sync(self.device)
        now = time.perf_counter()
        self.rows.append({"device": self.label, "group": group, "phase": name,
                          "ms": (now - self.last) * 1e3})
        self.last = now

    def mark_spans(self, rec, prefix: str, group: str = "") -> None:
        """A row a recorded span, its self time, in the order the spans
        closed; the next mark counts from now."""
        for (_, end, name, _), own in sorted(zip(rec.spans, rec.self_ns()),
                                             key=lambda x: x[0][1]):
            self.rows.append({"device": self.label, "group": group, "phase": prefix + name,
                              "ms": own / 1e6})
        self.last = time.perf_counter()

    def total(self, group: str = "") -> None:
        self.rows.append({"device": self.label, "group": group, "phase": "TOTAL",
                          "ms": (self.last - self.start) * 1e3})


def format_rows(rows: list) -> list:
    return [f"[{r['device']}] {r['group']:8s} {r['phase']:38s} {r['ms']:10.1f} ms" for r in rows]


def measure(device, num_payloads: int = 1, reps: int = 2, seed: int = 5) -> list:
    """The rows main() prints: dicts with group, phase, ms."""
    from ..bench import demo_context
    from ..claims import serde
    from ..claims.circuit import ZKlaimCircuit
    from ..ec import curve as C
    from ..groth16 import api as A
    from ..groth16.qap import QAP
    from ..msm.pippenger import msm_pow2

    device = torch.device(device)
    rng = random.Random(seed)
    ctx = demo_context(rng, device, num_payloads)
    m = Marks(device)

    circ = ZKlaimCircuit(num_payloads)
    m.mark("circuit build (host)", "holder")
    qap = QAP.for_cs(circ.cs, device)
    m.mark("QAP.for_cs (host)", "holder")
    pk, vk, _ = A.setup(circ.cs, rng, device)
    m.restart()
    raw = serde.pk_to_bytes(pk, num_payloads)
    m.mark("pk_to_bytes", "holder")
    pk, _ = serde.pk_from_bytes(raw, device)
    m.mark("pk_from_bytes (import)", "holder")
    inputs = [(p.pre, p.data_ref, p.op_positions()) for p in ctx.payloads]
    primary = circ.public_inputs(inputs)

    # warm-up: the kernels' build and first launches
    proof = A.prove(pk, qap, circ.witness(inputs), rng)
    assert A.verify(vk, primary, proof)

    for rep in range(reps):
        g = f"rep {rep}"
        m.restart()
        w = circ.witness(inputs)
        m.mark("witness build (host)", g)
        w_plain = A.upload_witness(w, device)
        m.mark("witness limbs -> device", g)
        h = A.h_plain(qap, w_plain, w)
        m.mark("h_pipeline (wmap+NTTs)", g)
        ev_a = msm_pow2(1, pk.a_g1, w_plain, 8)
        m.mark("msm A", g)
        ev_b1 = msm_pow2(1, pk.b_g1, w_plain, 8)
        m.mark("msm B1", g)
        ev_b2 = msm_pow2(2, pk.b_g2, w_plain, 8)
        m.mark("msm B2 (G2)", g)
        ev_h = msm_pow2(1, pk.h_g1, h, 8)
        m.mark("msm H", g)
        ev_l = msm_pow2(1, pk.l_g1, w_plain[pk.num_primary + 1 :], 8)
        m.mark("msm L", g)
        for deg, ev in ((1, ev_a), (1, ev_b1), (2, ev_b2), (1, ev_h), (1, ev_l)):
            C.planes_to_host_points(deg, ev)
        m.mark("device->host decode x5", g)
        m.total(g)

    for rep in range(reps):
        g = f"h split {rep}"
        w = circ.witness(inputs)
        w_plain = A.upload_witness(w, device)
        m.restart()
        with recording(sync=device) as rec:
            A.h_plain(qap, w_plain, w)
        m.mark_spans(rec, "h: ", g)
        m.total(g)

    # the prover as groth16.api.prove runs it
    for rep in range(reps):
        g = f"prove {rep}"
        w = circ.witness(inputs)
        m.restart()
        with device_trace(f"prove_{rep}"):
            w_plain = A.upload_witness(w, device)
            h = A.h_plain(qap, w_plain, w)
            m.mark("upload + h_pipeline", g)
            g1, g2 = A.prove_sums(pk, w_plain, h)
            m.mark("five sums (4 G1 batched, G2)", g)
            proof = A.finish_proof(pk, g1, g2, rng.randrange(A.R), rng.randrange(A.R))
            m.mark("host finish", g)
        m.total(g)

    m.restart()
    ok = A.verify(vk, primary, proof)
    m.mark(f"groth16.verify (ok={ok})", "verifier")
    assert ok
    return m.rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--payloads", type=int, default=1)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args()
    rows = measure(resolve_device(args.device), args.payloads, args.reps)
    print("\n".join(format_rows(rows)), flush=True)


if __name__ == "__main__":
    main()
