"""worker_claim: the claim step (steps/claim.py) on the holder of the
request's client, for a loop of several clients (loops/threads.py).

Each client has a worker state (roles.workers[client], made at the client's
first request; steps/worker_prove.py reads it by rec["client"]):

- holder: client 0's is roles.holder, which imports the pk with its first
  proof; another client's is a copy.deepcopy of it, which shares the
  imported pk and the built circuit (claims.api.Context.__deepcopy__);
- stream: the holder's own torch.cuda.Stream (None on the CPU);
- span: roles.span for client 0, a no-op for the others.  The card's idle
  gaps are charged to the spans open over them (tracing.record), so the
  step spans of one holder charge each gap once, by what that holder was
  doing; four holders' overlapping spans would charge a gap up to four
  times.

A window request's client is the number its thread carries; warm-up
request i, served on the main thread, is client i mod `clients`.  With at
least `clients` warm-up requests every holder and stream is made, and has
proved once, before the window: the caching allocator keeps a block for the
stream it was allocated on, so a stream's first proof would otherwise
allocate its scratch inside the window.

A fault of the control runs (harness.inject) replaces roles.holder's
proof_generate after warm-up, and a deep copy does not carry it: each
client's first window request puts the same fault into its own copy, so that
every holder of the window is broken.
"""

import contextlib
import copy
import threading
import types

import torch

from zkbench import harness

_LOCK = threading.Lock()


def _silent(name):
    return contextlib.nullcontext()


def worker(roles, rec: dict):
    """The worker state of request `rec`'s client."""
    client = getattr(threading.current_thread(), "client", None)
    if client is None:
        client = rec["index"] % roles.gen.params["clients"]
    rec["client"] = client
    with _LOCK:
        workers = roles.__dict__.setdefault("workers", {})
        if client not in workers:
            cuda = torch.device(roles.device).type == "cuda"
            workers[client] = types.SimpleNamespace(
                holder=roles.holder if client == 0 else copy.deepcopy(roles.holder),
                stream=torch.cuda.Stream(roles.device) if cuda else None,
                span=roles.span if client == 0 else _silent, in_window=False)
        mine = workers[client]
    if rec["stream"] == "window" and not mine.in_window:
        fault = vars(roles.holder).get("proof_generate")
        if fault is not None and mine.holder is not roles.holder:
            harness.inject(fault.__name__, types.SimpleNamespace(holder=mine.holder))
        mine.in_window = True
    return mine


def run(roles, rec: dict) -> None:
    mine = worker(roles, rec)
    cred = roles.pool[rec["credential"]]
    with mine.span("claim"):
        rec["claim"] = roles.gen.claim(rec["stream"], rec["index"], cred["attrs"])
        mine.holder.payloads = [
            roles.Payload(data_ref=list(refs), data_op=list(ops), salt=salt, hash=digest,
                          pre=pre)
            for (refs, ops), salt, digest, pre
            in zip(rec["claim"], cred["salt"], cred["hash"], cred["pre"])]
        mine.holder.signature = cred["signature"]
