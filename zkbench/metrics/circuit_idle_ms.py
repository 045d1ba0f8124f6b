"""circuit_idle_ms: the card's idle time while the innermost span the host
was in was a fresh holder's build of its circuit (claims.circuit, the
copies of r1cs/system and claims/circuit building ZKlaimCircuit(N)) or of
the circuit's witness program (claims.witness_program), in ms per completed
request; read as pk_import_idle_ms is.  Moves proofs_per_s."""

from zkbench.metrics.pk_import_idle_ms import idle_ms

NAMES = ("claims.circuit", "claims.witness_program")


def read(rec: dict):
    return idle_ms(rec, NAMES)
