"""groth16_idle_ms: the card's idle time while the innermost span the host was
in was one of groth16.* (the upload, the witness map, the satisfaction
check, the host finish), in ms per completed request.  Moves proofs_per_s."""

from zkbench.program_spans import layer_idle_ms


def read(rec: dict):
    return layer_idle_ms(rec, "groth16")
