"""Share of the window's decode passes that computed for no row: gated
replays of a step chunk after a row finished inside it, or with no row
running (1 - Δ``counts["live_decode_passes"]`` / Δ``counts["decode_passes"]``),
in percent.  None where the program keeps no count of live passes."""
from benchmark.harness.readings import delta


def read(record):
    c0, c1 = record["c0"], record["c1"]
    if "live_decode_passes" not in c0["counts"]:
        return None
    passes = delta(c0, c1, "counts", "decode_passes")
    if not passes:
        return None
    return 100.0 * (1.0 - delta(c0, c1, "counts", "live_decode_passes") / passes)
