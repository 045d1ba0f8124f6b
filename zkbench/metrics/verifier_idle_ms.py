"""verifier_idle_ms: the card's idle time while the innermost span the host was
in was one of verifier.* (the signature, the vk's and proof's decoding with
their subgroup checks, the pairing), in ms per completed request.  Moves
verify_ms_p95."""

from zkbench.program_spans import layer_idle_ms


def read(rec: dict):
    return layer_idle_ms(rec, "verifier")
