"""pk_import_idle_ms: the card's idle time while the innermost span the host
was in was part of a fresh holder's pk import (claims.pk_import: the host
decode and send serde.pk_decode, the checks serde.pk_check, the QAP's build
groth16.qap), in ms per completed request.  The spans come from the
program's recorder, which steps/fresh_holder.py runs over each traced
request; None where none of them met an idle gap or the trace saw no device
activity.  Moves proofs_per_s."""

NAMES = ("claims.pk_import", "serde.pk_decode", "serde.pk_check", "groth16.qap")


def idle_ms(rec: dict, names):
    """The card's idle time under the spans `names`, ms a completed request."""
    by_span = rec.get("idle_s_by_span", {})
    mine = [by_span[name] for name in names if name in by_span]
    if not mine or not rec["kernel_count"] or not rec["requests"]:
        return None
    return 1e3 * sum(mine) / rec["requests"]


def read(rec: dict):
    return idle_ms(rec, NAMES)
