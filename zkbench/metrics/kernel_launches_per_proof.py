"""kernel_launches_per_proof: every kernel the card ran in the traced window
(the port's own and PyTorch's), over the requests completed in it.
Moves proofs_per_s."""


def read(rec: dict):
    if not rec["kernel_count"] or not rec["requests"]:
        return None
    return rec["kernel_count"] / rec["requests"]
