"""device_idle_pct: the share of the traced window in which nothing ran on
the card (no kernel, copy or set), in %.  Moves proofs_per_s."""


def read(rec: dict):
    if not rec["kernel_count"] or rec["window_s"] <= 0:
        return None                                 # the trace saw no device activity
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
