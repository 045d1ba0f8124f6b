"""worker_prove: the prove step (steps/prove.py) on the holder of the
request's client (steps/worker_claim.py made it): `proof_generate` under the
holder's own CUDA stream, ending in that stream's synchronise, not the
device's, so that the other holders' work goes on meanwhile; its status and
its proof bytes."""

import torch


def run(roles, rec: dict) -> None:
    mine = roles.workers[rec["client"]]
    with mine.span("proof_generate"):
        rng = roles.gen.rng(f"{rec['stream']}.prove", rec["index"])
        with torch.cuda.stream(mine.stream):
            rec["statuses"]["prove"] = mine.holder.proof_generate(rng)
        if mine.stream is not None:
            mine.stream.synchronize()
    rec["proof"] = mine.holder.proof
