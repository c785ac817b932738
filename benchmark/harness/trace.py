"""A profiled slice of the window: ``torch.profiler`` over the card (its
kernels, copies and fills, and the CUDA runtime calls of the host), reduced
to the device's kernels, its busy time, and its idle gaps keyed by the
runtime call open during each.

The profiler starts while the window runs and stops only once the window's
requests have drained and the pool is idle: stopping it while another
thread launches work on the card hung a run for 50 minutes.  The events are
then cut to the slice by the wall clock, which is the profiler's own.
"""
from __future__ import annotations

import os
import threading

import numpy as np


def kernel_kind(name: str) -> str:
    """The kind of a device kernel, by its name (the port's
    ``tools/profile_torch_slice.py`` classifier, with the paged kernels)."""
    if "flash_decode_" in name or "flash_attention_" in name:
        return "flash_attention"
    if "paged_" in name:
        return "paged_attention"
    if "int4_" in name:
        return "int4_matmul"
    if any(k in name for k in ("nvjet", "gemm", "gemv", "splitKreduce", "cutlass")):
        return "gemm"
    if "copy_kernel" in name or "Memcpy" in name or "memcpy" in name:
        return "copy"
    if "softmax" in name.lower():
        return "softmax"
    return "other"


def start_profiler():
    """The profiler, started; None without a card (nothing to profile)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        return None
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def stop_profiler(prof, log, timeout_s: float = 120.0) -> None:
    """Stop the profiler; a stop that takes ``timeout_s`` ends the process
    (exit code 3) rather than leave the run hanging."""
    done = threading.Event()

    def watchdog():
        if not done.wait(timeout_s):
            log(f"the profiler did not stop within {timeout_s} s; ending the run")
            os._exit(3)

    threading.Thread(target=watchdog, daemon=True).start()
    prof.__exit__(None, None, None)
    done.set()


def _ns(e, what: str) -> int:
    f = getattr(e, what + "_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, what + "_us")() * 1000)


def events(prof, wall_ns):
    """-> (device, host): arrays of (start_ns, end_ns) and their names, of
    the events that start inside ``wall_ns`` (a (start, end) of
    ``time.time_ns()``)."""
    import torch

    dev, dev_names, host, host_names = [], [], [], []
    for e in prof.profiler.kineto_results.events():
        s, d = _ns(e, "start"), _ns(e, "duration")
        if not wall_ns[0] <= s < wall_ns[1]:
            continue
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append((s, s + d))
            dev_names.append(e.name())
        else:
            host.append((s, s + d))
            host_names.append(e.name())
    return ((np.asarray(dev, np.int64).reshape(-1, 2), dev_names),
            (np.asarray(host, np.int64).reshape(-1, 2), host_names))


def union(iv: np.ndarray) -> np.ndarray:
    """Merged, sorted intervals."""
    if len(iv) == 0:
        return iv
    iv = iv[np.argsort(iv[:, 0])]
    out = []
    s, e = iv[0]
    for a, b in iv[1:]:
        if a > e:
            out.append((s, e))
            s, e = a, b
        elif b > e:
            e = b
    out.append((s, e))
    return np.asarray(out, np.int64)


def reduce(prof, wall_ns, gaps_named: int = 2000) -> dict:
    """The slice's device kernels ``[(name, seconds)]`` summed by name, its
    busy seconds (the union of device intervals), its length, and the idle
    gaps' seconds by the innermost host call open at each gap's middle (the
    ``gaps_named`` longest gaps)."""
    window_s = (wall_ns[1] - wall_ns[0]) * 1e-9
    (dev, dev_names), (host, host_names) = events(prof, wall_ns)
    by_name: dict = {}
    for (s, e), n in zip(dev, dev_names):
        by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-9
    busy = union(dev)
    busy_s = float((busy[:, 1] - busy[:, 0]).sum()) * 1e-9 if len(busy) else 0.0
    idle_by_host: dict = {}
    if len(busy) > 1:
        gaps = np.stack([busy[:-1, 1], busy[1:, 0]], 1)
        length = gaps[:, 1] - gaps[:, 0]
        longest = np.argsort(-length)[:gaps_named]
        mids = (gaps[longest, 0] + gaps[longest, 1]) // 2
        hs, he = host[:, 0], host[:, 1]
        dur = he - hs
        for m, g in zip(mids, longest):
            open_ = np.flatnonzero((hs <= m) & (he >= m))
            name = host_names[open_[np.argmin(dur[open_])]] if len(open_) else "(no runtime call)"
            idle_by_host[name] = idle_by_host.get(name, 0.0) + length[g] * 1e-9
    kinds: dict = {}
    for n, t in by_name.items():
        kinds[kernel_kind(n)] = kinds.get(kernel_kind(n), 0.0) + t
    return {"kernels": by_name, "kinds": kinds, "busy_s": busy_s, "window_s": window_s,
            "idle_by_host": idle_by_host, "n_device_events": len(dev)}


def breakdown(sl: dict, top: int = 10) -> dict:
    """The result line's ``breakdown``: the device operations that took most
    time (kinds first, then kernels by name) and the idle time by host
    operation, at most ``top`` entries each."""
    kinds = sorted(sl["kinds"].items(), key=lambda kv: -kv[1])[:4]
    names = sorted(sl["kernels"].items(), key=lambda kv: -kv[1])[:top - len(kinds)]
    ops = [["kind:" + k, v] for k, v in kinds] + [[n[:120], v] for n, v in names]
    idle = sorted(sl["idle_by_host"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": ops, "idle_gaps": [[n[:120], v] for n, v in idle]}
