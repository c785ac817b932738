"""The program's spans in the profiled slice, and the slice's device and idle
time put down to the spans of the Scheduler's thread.

The port records spans (``visualcla_tpu_torch.utils.profiling``) while a
torch.profiler session runs, on the profiler's clock (``time.time_ns()``).
A slice's spans are ``record["slice"]["spans"]`` where the driver stored
them; otherwise they are taken from the program after the run, the slice's
bounds carried from ``time.perf_counter`` to that clock.  A program without
the recorder gives None.

Device time (where the slice holds ``device``: each device event's
interval and the start of the runtime call that launched it, matched by
correlation id, or -1): a kernel belongs to the innermost span of the
Scheduler's thread open when its launching call started (its own start
where none matched), so a kernel launched under one span that runs during
the next counts for the first.  Idle card time (the slice less the union
of device intervals, ``wall_ns`` its bounds) belongs to the spans of that
thread open over it.  The Scheduler's thread is the only one that launches
device work on the served path.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from benchmark.harness.trace import union

# top-level spans of the Scheduler's thread that admit a request
ADMIT = ("sched.admit", "sched.admit_begin", "sched.admit_stage")


def _program_take_spans():
    """The port's ``take_spans``, or None where the program has no recorder."""
    try:
        from visualcla_tpu_torch.utils import profiling
    except ImportError:
        return None
    return getattr(profiling, "take_spans", None)


def slice_spans(record: dict) -> Optional[List[dict]]:
    """The spans that start in the profiled slice, by start; None without a
    slice or a recorder.  Taken from the program once, then kept in the
    slice."""
    sl = record.get("slice")
    if not sl:
        return None
    if "spans" not in sl:
        take = _program_take_spans()
        if take is None:
            return None
        offset = time.time_ns() - time.perf_counter_ns()
        sl["spans"] = take(round(sl["t0"] * 1e9) + offset, round(sl["t1"] * 1e9) + offset)
    return sl["spans"]


def scheduler_tid(spans: List[dict]) -> Optional[int]:
    """The OS thread of the Scheduler's own spans."""
    tids = [d["tid"] for d in spans if d["name"].startswith("sched.")
            and d["name"] != "sched.queue_wait"]
    return max(set(tids), key=tids.count) if tids else None


def durations_s(spans: List[dict], name: str) -> np.ndarray:
    return np.asarray([(d["end_ns"] - d["start_ns"]) * 1e-9 for d in spans
                       if d["name"] == name])


def thread_spans(spans: List[dict], tid, top: bool = False) -> List[dict]:
    """The spans of thread ``tid`` (its top-level ones alone with ``top``)."""
    return [d for d in spans if d["tid"] == tid and (not top or d["parent"] is None)]


def _iv(spans: List[dict]) -> np.ndarray:
    return np.asarray([(d["start_ns"], d["end_ns"]) for d in spans], np.int64).reshape(-1, 2)


def owners(iv: np.ndarray):
    """-> (bounds, owner): ``owner[k]`` indexes the innermost of the nested
    intervals ``iv`` (n, 2) open over [bounds[k], bounds[k + 1]), -1 for
    none.  They are painted outermost first, so the inner ones win."""
    s, e = iv[:, 0], iv[:, 1]
    bounds = np.unique(np.concatenate([s, e]))
    owner = np.full(len(bounds), -1, np.int64)
    for i in np.lexsort((-e, s)):
        owner[np.searchsorted(bounds, s[i]):np.searchsorted(bounds, e[i])] = i
    return bounds, owner


def owner_at(bounds: np.ndarray, owner: np.ndarray, t_ns) -> np.ndarray:
    """The ``owners`` index open at each time of ``t_ns`` (-1 for none)."""
    t_ns = np.asarray(t_ns, np.int64)
    if len(bounds) == 0:
        return np.full(t_ns.shape, -1, np.int64)
    k = np.searchsorted(bounds, t_ns, side="right") - 1
    return np.where((k >= 0) & (k < len(bounds) - 1), owner[k.clip(0, len(owner) - 1)], -1)


def idle_intervals(sl: dict) -> np.ndarray:
    """The slice's intervals in which no device event ran."""
    w0, w1 = sl["wall_ns"]
    busy = union(np.clip(np.asarray(sl["device"]["intervals"], np.int64).reshape(-1, 2), w0, w1))
    edges = np.concatenate([[w0], busy.reshape(-1), [w1]]).reshape(-1, 2)
    return edges[edges[:, 1] > edges[:, 0]]


def overlap_ns(a: np.ndarray, b: np.ndarray) -> int:
    """Total length of the intersection of the unions of two sets of intervals."""
    a, b = union(a.reshape(-1, 2)), union(b.reshape(-1, 2))
    total, j = 0, 0
    for s, e in a:
        while j < len(b) and b[j, 1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k, 0] < e:
            total += min(e, b[k, 1]) - max(s, b[k, 0])
            k += 1
    return int(total)


def _device(record: dict):
    """(slice, its spans, the Scheduler's thread) where the slice holds
    device events and spans of that thread; else None."""
    sl = record.get("slice")
    if not sl or "device" not in sl:
        return None
    spans = slice_spans(record)
    tid = scheduler_tid(spans) if spans else None
    return None if tid is None else (sl, spans, tid)


def device_s_by_top(record: dict) -> Optional[Dict[str, float]]:
    """Device seconds of the slice's kernels by the top-level Scheduler span
    open at their launch (``None`` for kernels launched outside any)."""
    found = _device(record)
    if found is None:
        return None
    sl, spans, tid = found
    tops = thread_spans(spans, tid, top=True)
    iv = np.asarray(sl["device"]["intervals"], np.int64).reshape(-1, 2)
    launch = np.asarray(sl["device"]["launch_ns"], np.int64)
    at = np.where(launch >= 0, launch, iv[:, 0])
    idx = owner_at(*owners(_iv(tops)), at)
    out: Dict[str, float] = {}
    for i, (s, e) in zip(idx, iv):
        name = tops[i]["name"] if i >= 0 else None
        out[name] = out.get(name, 0.0) + float(e - s) * 1e-9
    return out


def idle_s_under(record: dict, names) -> Optional[float]:
    """Idle card seconds of the slice while the Scheduler's thread is inside
    a top-level span named in ``names`` (any, for None)."""
    found = _device(record)
    if found is None:
        return None
    sl, spans, tid = found
    tops = [d for d in thread_spans(spans, tid, top=True) if names is None or d["name"] in names]
    return overlap_ns(idle_intervals(sl), _iv(tops)) * 1e-9


def idle_breakdown(record: dict) -> Optional[Dict[str, float]]:
    """Each idle gap of the slice, in full, by what was open at its middle:
    the innermost runtime call (``runtime`` in the slice), else
    ``span:<name>`` of the innermost Scheduler-thread span, else
    ``(no runtime call)``."""
    found = _device(record)
    if found is None:
        return None
    sl, spans, tid = found
    gaps = idle_intervals(sl)
    mids = (gaps[:, 0] + gaps[:, 1]) // 2
    rt = sl.get("runtime") or {"intervals": np.zeros((0, 2), np.int64), "names": []}
    in_call = owner_at(*owners(np.asarray(rt["intervals"], np.int64).reshape(-1, 2)), mids)
    mine = thread_spans(spans, tid)
    in_span = owner_at(*owners(_iv(mine)), mids)
    out: Dict[str, float] = {}
    for (s, e), c, i in zip(gaps, in_call, in_span):
        name = (rt["names"][c] if c >= 0 else "span:" + mine[i]["name"] if i >= 0
                else "(no runtime call)")
        out[name] = out.get(name, 0.0) + float(e - s) * 1e-9
    return out


def completed_admissions(spans: List[dict]) -> int:
    """One-shot admissions and chunked admissions' last stages."""
    return sum(1 for d in spans if d["name"] == "sched.admit"
               or (d["name"] == "sched.admit_stage" and d["attrs"].get("done")))
