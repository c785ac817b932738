"""Tokens that reached their requests inside the window, over its seconds
(host clock): every request's, those due before it included."""
from benchmark.harness.readings import tokens_between, window_s


def read(record):
    n = sum(1 for _ in tokens_between(record, record["t0"], record["t1"]))
    return n / window_s(record)
