"""Decoded tokens (every token after a request's first) received in the
window, per decode pass the pool ran in it (``counts["decode_passes"]``,
gated passes included)."""
from benchmark.harness.readings import delta, tokens_between


def read(record):
    passes = delta(record["c0"], record["c1"], "counts", "decode_passes")
    n = sum(1 for _, j in tokens_between(record, record["t0"], record["t1"]) if j >= 1)
    return n / passes if passes else None
