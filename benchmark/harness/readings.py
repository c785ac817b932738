"""What the metric readers share: the window, the requests' times and the
counters read around the window and the profiled slice."""
from __future__ import annotations

import json
import os

import numpy as np

# the pool's prompt buckets (``PagedServingEngine``'s default), for the
# token count of an admission
PROMPT_BUCKETS = (128, 256, 512, 1024)


def window_s(record: dict) -> float:
    return record["t1"] - record["t0"]


def done(r) -> bool:
    return r.final is not None and r.error is None and bool(r.times)


def ttfts(record: dict) -> np.ndarray:
    """Seconds from each request's due time to its first token; a request
    that failed or never finished counts as waiting until the drain ended."""
    end = record["t1"] + record["cell"]["drain_s"]
    return np.asarray([(r.times[0] if done(r) else end) - r.due for r in record["requests"]])


def tail(values, q: float) -> float:
    """The q-th percentile, as the nearest sample at or above it."""
    return float(np.percentile(np.asarray(values), q, method="higher"))


def tokens_between(record: dict, a: float, b: float):
    """(request, index) of every token received in [a, b)."""
    for r in record["requests"]:
        for j, t in enumerate(r.times):
            if a <= t < b:
                yield r, j


def delta(c0: dict, c1: dict, *path) -> float:
    a, b = c0, c1
    for k in path:
        a, b = a[k], b[k]
    return b - a


def bucket(n: int) -> int:
    return next((b for b in PROMPT_BUCKETS if b >= n), -(-n // 64) * 64)


def kernel_seconds(record: dict, names_file: str):
    """Device seconds in the slice of the kernels whose names contain one of
    the substrings listed in ``names_file``; None without a slice or a match."""
    sl = record.get("slice")
    if not sl:
        return None
    with open(names_file) as f:
        subs = json.load(f)["name_contains"]
    t = sum(v for n, v in sl["kernels"].items() if any(s in n for s in subs))
    return t or None


def beside(path: str, suffix: str) -> str:
    """A data file next to a reader: ``<reader without .py><suffix>``."""
    return os.path.splitext(path)[0] + suffix
