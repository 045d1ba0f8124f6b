"""msm_padding_pct: the share of the MSM's lanes that are infinity rows
added by padding (100 x msm.padded_lanes / msm.lanes, the program's
counters in the window), in %.  Moves proofs_per_s."""


def read(rec: dict):
    counts = rec.get("counts", {})
    if not counts.get("msm.lanes"):
        return None
    return 100.0 * counts.get("msm.padded_lanes", 0) / counts["msm.lanes"]
