"""Share of the window's admission stages (encode, tower chunk, scatter,
first token: Δ``counts["admit_stages"]``) that ran from a captured graph
(Δ``counts["admit_replays"]``), in percent.  None where the program keeps no
count of admission stages, or ran none in the window."""
from benchmark.harness.readings import delta


def read(record):
    c0, c1 = record["c0"], record["c1"]
    if "admit_stages" not in c0["counts"]:
        return None
    stages = delta(c0, c1, "counts", "admit_stages")
    if not stages:
        return None
    return 100.0 * delta(c0, c1, "counts", "admit_replays") / stages
