"""holders_in_flight: the mean number of holders proving at once, as a proof
starts: the program's counter claims.in_flight (at each `proof_generate`
start, the calls running, that one included) over the requests completed
in the window.  A loop closes its window only once every request it
started has ended, so each request's one proof starts inside the window.
Read where the program's recorder was on (trace_layers.py); None where
its counts are absent.  Moves proofs_per_s."""


def read(rec: dict):
    counts = rec.get("counts", {})
    if not counts.get("claims.in_flight") or not rec["requests"]:
        return None
    return counts["claims.in_flight"] / rec["requests"]
