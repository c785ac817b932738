"""Median time to first token over every request due in the window, from
its due time (host clock)."""
from benchmark.harness.readings import tail, ttfts


def read(record):
    return tail(ttfts(record), 50) * 1e3
