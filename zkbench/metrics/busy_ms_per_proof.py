"""busy_ms_per_proof: the card's busy time (the union of its kernels, copies
and sets in the traced window) over the requests completed in it, in ms.
Where several holders prove at once it falls as the kernels of different
proofs overlap on the card and rises as they contend.  Moves proofs_per_s."""


def read(rec: dict):
    if not rec["kernel_count"] or not rec["requests"]:
        return None                                 # the trace saw no device activity
    return 1e3 * rec["busy_s"] / rec["requests"]
