"""msm_idle_ms: the card's idle time while the innermost span the host was in
was one of msm.* (the sums' passes: digits, sort, gather, upsweep, tails,
Abel tree; the finish), in ms per completed request.  Moves proofs_per_s."""

from zkbench.program_spans import layer_idle_ms


def read(rec: dict):
    return layer_idle_ms(rec, "msm")
