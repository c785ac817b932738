"""Tracing and profiling: per-phase timers, counters and torch.profiler
traces (port of visualcla_tpu/utils/profiling.py).

- ``PhaseTimer``: named phase timing (preprocess / vision / prefill /
  decode) that waits for the calling stream before it stops the clock, so the
  numbers mean something under asynchronous launches;
- ``span()``: named intervals of host work on the clock of torch.profiler's
  events (``time.time_ns()``), kept in a bounded buffer while recording is on
  (``record_spans(True)``, or while a ``torch.profiler`` session runs) and
  read with ``take_spans``; off, a span site costs one check;
- ``trace()``: a context manager around ``torch.profiler`` writing a Chrome /
  TensorBoard trace into a directory, the spans of its block beside the
  profiler's events;
- ``Counters``: process-wide monotonic counters (tokens generated, requests,
  speculative chunks) for the serving surfaces.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.autograd import profiler as _torch_profiler

if not hasattr(_torch_profiler, "_is_profiler_enabled"):  # a torch without the flag
    _torch_profiler = type("_NoProfilerFlag", (), {"_is_profiler_enabled": False})


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
        """Time the block as phase ``name`` (and record it as a span of that
        name while spans are recorded)."""
        with span(name):
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


# -- spans ---------------------------------------------------------------------

# spans a recorder keeps (the oldest go first): ~20 MB at most
SPAN_CAPACITY = 1 << 17


class _NoSpan:
    """What ``span`` returns while nothing is recorded: one shared object."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("_rec", "name", "rid", "attrs", "start_ns")

    def __init__(self, rec: "SpanRecorder", name: str, rid, attrs: dict):
        self._rec, self.name, self.rid, self.attrs = rec, name, rid, attrs

    def __enter__(self):
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self._rec._append(self.name, self.start_ns, time.time_ns(), threading.get_native_id(),
                          self.rid, self.attrs)


class SpanRecorder:
    """Spans of host work in a bounded buffer.

    A span is (name, start, end, the OS thread, the request id ``rid``,
    attributes), its times from ``time.time_ns()``, the clock of
    torch.profiler's events, so that a span and the device work launched
    inside it line up in one trace.  A span's parent is the innermost span
    of its thread that encloses it, worked out when the spans are taken; a
    span without a ``rid`` takes its parent's.

    Recording is on while ``record(True)`` holds and while a torch.profiler
    session runs in the process.  Off, ``span`` returns one shared no-op
    object after that check: no lock, no device sync, and no allocation but
    the dict of keyword attributes a call site passes."""

    def __init__(self, capacity: int = SPAN_CAPACITY):
        self._spans: collections.deque = collections.deque(maxlen=capacity)
        self._ids = itertools.count()
        self._lock = threading.Lock()
        self._on = False

    def record(self, on: bool) -> None:
        """Turn recording on or off (a running torch.profiler records too)."""
        self._on = bool(on)

    def recording(self) -> bool:
        return self._on or _torch_profiler._is_profiler_enabled

    def span(self, name: str, rid: Optional[int] = None, **attrs):
        """A context manager recording its block as span ``name``."""
        if not (self._on or _torch_profiler._is_profiler_enabled):
            return _NO_SPAN
        return _Span(self, name, rid, attrs)

    def add(self, name: str, start_ns: int, end_ns: int, rid: Optional[int] = None,
            tid: Optional[int] = None, **attrs) -> None:
        """Record a span the caller timed: with clock reads it takes anyway,
        or one that opened on another thread (``tid``, default this one)."""
        if self._on or _torch_profiler._is_profiler_enabled:
            self._append(name, start_ns, end_ns, tid or threading.get_native_id(), rid, attrs)

    def _append(self, name, start_ns, end_ns, tid, rid, attrs) -> None:
        with self._lock:
            self._spans.append((next(self._ids), name, start_ns, end_ns, tid, rid, attrs))

    def take(self, t0_ns: Optional[int] = None, t1_ns: Optional[int] = None) -> List[dict]:
        """The kept spans that start in [t0_ns, t1_ns) (all by default), by
        start, as dicts: ``id``, ``name``, ``start_ns``, ``end_ns``, ``tid``,
        ``parent`` (an ``id`` or None), ``rid`` and ``attrs``.  The buffer
        keeps them."""
        with self._lock:
            kept = list(self._spans)
        out = [{"id": i, "name": n, "start_ns": s, "end_ns": e, "tid": tid, "parent": None,
                "rid": rid, "attrs": dict(a)} for i, n, s, e, tid, rid, a in kept]
        out.sort(key=lambda d: (d["start_ns"], -d["end_ns"], d["id"]))
        open_: Dict[int, list] = {}  # tid -> the spans enclosing the current one
        for d in out:
            stack = open_.setdefault(d["tid"], [])
            while stack and stack[-1]["end_ns"] < d["end_ns"]:
                stack.pop()
            if stack:
                d["parent"] = stack[-1]["id"]
                if d["rid"] is None:
                    d["rid"] = stack[-1]["rid"]
            stack.append(d)
        lo = -1 if t0_ns is None else t0_ns
        hi = float("inf") if t1_ns is None else t1_ns
        return [d for d in out if lo <= d["start_ns"] < hi]


SPANS = SpanRecorder()
span = SPANS.span
add_span = SPANS.add
record_spans = SPANS.record
take_spans = SPANS.take


def _chrome_events(spans: List[dict], base_ns: int) -> List[dict]:
    """Spans as Chrome trace complete events ("X", microseconds from
    ``base_ns``), in the process's row and each span's OS thread."""
    pid = os.getpid()
    return [{"ph": "X", "cat": "span", "name": d["name"], "pid": pid, "tid": d["tid"],
             "ts": (d["start_ns"] - base_ns) / 1e3, "dur": (d["end_ns"] - d["start_ns"]) / 1e3,
             "args": {"id": d["id"], "parent": d["parent"], "rid": d["rid"], **d["attrs"]}}
            for d in spans]


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler around a code block, CPU and CUDA activities (CPU only
    without a GPU); the trace goes to ``log_dir/trace.json`` (Chrome trace
    format: open it in Perfetto or TensorBoard), with the spans recorded over
    the block on the profiler's own time base.  Yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    t0 = time.time_ns()
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        sync()
    t1 = time.time_ns()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    doc["traceEvents"] += _chrome_events(take_spans(t0, t1),
                                         int(doc.get("baseTimeNanoseconds", 0)))
    with open(path, "w") as f:
        json.dump(doc, f)


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
