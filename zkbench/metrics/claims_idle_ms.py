"""claims_idle_ms: the card's idle time while the innermost span the host was
in was one of claims.* (the credential API: the circuit, the pk import, the
witness build, the proof's bytes), in ms per completed request.  Moves
proofs_per_s."""

from zkbench.program_spans import layer_idle_ms


def read(rec: dict):
    return layer_idle_ms(rec, "claims")
