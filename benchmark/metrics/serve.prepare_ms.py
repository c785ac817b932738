"""Median ``serve.prepare`` span of the profiled slice (``PoolWorker.
_prepare_request``: the image decode, the host processor, the prompt, on
the client's thread), in ms.  None where the program records no spans."""
import numpy as np

from benchmark.harness.spans import durations_s, slice_spans


def read(record):
    spans = slice_spans(record)
    d = durations_s(spans, "serve.prepare") if spans else []
    return float(np.median(d)) * 1e3 if len(d) else None
