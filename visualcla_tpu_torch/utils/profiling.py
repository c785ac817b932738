"""Tracing and profiling: per-phase timers, counters and torch.profiler
traces (port of visualcla_tpu/utils/profiling.py).

- ``PhaseTimer``: named phase timing (preprocess / vision / prefill /
  decode) that waits for the calling stream before it stops the clock, so the
  numbers mean something under asynchronous launches;
- ``trace()``: a context manager around ``torch.profiler`` writing a Chrome /
  TensorBoard trace into a directory;
- ``Counters``: process-wide monotonic counters (tokens generated, requests,
  speculative chunks) for the serving surfaces.
"""
from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Dict

import numpy as np
import torch


def sync(x=None) -> None:
    """Wait for the work queued so far on the calling thread's current CUDA
    stream: of ``x``'s device when ``x`` is a CUDA tensor, of the current
    device when ``x`` is None and a GPU is present; nothing for a CPU tensor
    (its work is done when it returns).  Only that stream, as JAX waits on
    the value only: another thread's work on the card is not waited for."""
    if x is None:
        if torch.cuda.is_available():
            torch.cuda.current_stream().synchronize()
    elif isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.current_stream(x.device).synchronize()


class PhaseTimer:
    """Accumulates wall time per named phase.

    >>> t = PhaseTimer()
    >>> with t.phase("prefill", sync_on=state.last_token): ...
    >>> t.summary()  # {'prefill': {'total_s': ..., 'count': ..., 'p50_ms': ...}}

    Inside the block, ``result["sync_on"] = tensor`` names the tensor to
    wait for when it is known only there."""

    def __init__(self):
        self._times: Dict[str, list] = collections.defaultdict(list)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def phase(self, name: str, sync_on=None):
        t0 = time.perf_counter()
        result = {}
        try:
            yield result
        finally:
            if sync_on is not None:
                sync(sync_on)
            elif "sync_on" in result:
                sync(result["sync_on"])
            dt = time.perf_counter() - t0
            with self._lock:
                self._times[name].append(dt)

    def summary(self) -> Dict[str, dict]:
        out = {}
        with self._lock:
            for name, ts in self._times.items():
                arr = np.asarray(ts)
                out[name] = {
                    "count": len(ts),
                    "total_s": float(arr.sum()),
                    "mean_ms": float(arr.mean() * 1e3),
                    "p50_ms": float(np.median(arr) * 1e3),
                    "p95_ms": float(np.percentile(arr, 95) * 1e3),
                }
        return out

    def reset(self) -> None:
        with self._lock:
            self._times.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler around a code block, CPU and CUDA activities (CPU only
    without a GPU); the trace goes to ``log_dir/trace.json`` (Chrome trace
    format: open it in Perfetto or TensorBoard).  Yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        sync()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Counters:
    """Monotonic named counters (thread-safe)."""

    def __init__(self):
        self._c: Dict[str, int] = collections.defaultdict(int)
        self._lock = threading.Lock()

    def add(self, name: str, value: int = 1) -> None:
        with self._lock:
            self._c[name] += value

    def get(self, name: str) -> int:
        with self._lock:
            return self._c[name]

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._c)


GLOBAL_COUNTERS = Counters()
GLOBAL_TIMER = PhaseTimer()
