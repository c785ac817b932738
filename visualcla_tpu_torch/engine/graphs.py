"""Captured CUDA graphs: the port's counterpart of the JAX package's
device-resident decode loops (``lax.while_loop``).

Each decode loop has a step function over device tensors only, gated on the
device by the JAX loop's own ``cond`` as a ``go`` flag: a step with
``go == False`` changes no state (no counter advances, no id is written, no
``kv_valid`` bit is set; its cache write goes to a slot that is not valid or
to the paged pool's dummy block 0).  On the card ``Graphs.run`` captures the
step once per static key and replays it ``n`` times, a chunk; the host reads
one small control tensor a chunk.  (One captured step replayed costs a few
microseconds of launch a step and an eighth of the capture of an 8-step
graph, which a new key pays inside a request.)  On CPU tensors, and inside
``eager()``, the same steps run eagerly.

Capture: the step runs once on the capture stream gated off
(``enable`` False; the generators' states are restored after, so this
warm-up consumes no random numbers), which builds the kernels and sets up
cuBLAS outside the capture; then it is captured with each
``torch.Generator`` it draws from registered with the graph, so a replay
draws what the eager chunk would.  All graphs of one ``Graphs`` share one
memory pool.  A capture or replay that fails raises: there is no eager
fallback on the card.

Launch counts: while a chunk is captured nothing runs, so the counters it
bumps (the kernels' ``LAUNCHES``, the mesh's collectives ``parallel.tp.CALLS``
and the caller's own) are put back, and each replay adds what the capture
recorded: the counters count what ran.

Over a mesh (NCCL): a step's collectives are captured with it.  The
warm-up runs every collective once eagerly, on the capture stream, which
builds the group's NCCL communicator before the capture; every rank runs
the same calls, so every rank captures the same graphs in the same order.

Threads: every ``run`` (capture and replays) holds the process-wide
``LOCK``, so a capture never meets another thread's replay, its counter
updates or its reads of a ``go`` flag; eager device work that bumps the
kernel counters outside ``run`` takes it too.  A capture is made in
``thread_local`` mode: another thread's host copies and allocations may go
on meanwhile, on its own stream.  Graphs are kept per key space, each with
its own budget: the prefill-shaped programs (``Engine.start``, the
contiguous pool's admission, the image encode) never evict a decode loop's
graph.
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Callable, Hashable, Iterable

import torch

from ..ops.cuda import flash_attention as _fa
from ..ops.cuda import int4_matmul as _i4
from ..ops.cuda import moe_int4 as _b7
from ..ops.cuda import paged_attention as _pa
from ..ops.cuda import selective_scan as _b8
from ..parallel import tp as _tp
from ..utils.profiling import span

# the kernels' launch counters, and the mesh's collectives (parallel.tp.CALLS)
KERNEL_COUNTERS = (_fa.LAUNCHES, _i4.LAUNCHES, _pa.LAUNCHES, _b7.LAUNCHES, _b8.LAUNCHES,
                   _tp.CALLS)
# graphs a Graphs keeps a key space (the least recently replayed goes first)
MAX_GRAPHS = {"decode": 16, "prefill": 32}
_EAGER = [False]
# held by every capture and replay, and by eager device work that launches
# counted kernels, so that no capture in another thread sees its counts
LOCK = threading.RLock()


@contextlib.contextmanager
def eager():
    """Within the block every decode loop runs its chunks eagerly, on the card
    too (to hold a captured run against the eager one, or to swap the
    kernels' plain versions in)."""
    prev = _EAGER[0]
    _EAGER[0] = True
    try:
        yield
    finally:
        _EAGER[0] = prev


class _Graph:
    def __init__(self, graph: torch.cuda.CUDAGraph, deltas: list):
        self.graph = graph
        self.deltas = deltas  # [(counter dict, name, count a replay)]

    def replay(self) -> None:
        self.graph.replay()
        for counter, name, n in self.deltas:
            counter[name] += n


def _snapshot(counters) -> list:
    return [dict(c) for c in counters]


class Graphs:
    """Steps captured by key for one owner (an engine), at most
    ``MAX_GRAPHS`` of them.  ``captures``, ``capture_s`` (seconds of warm-up, capture and
    instantiation), ``replays`` and ``pool_bytes`` (device memory of the
    graphs' private pool) say what the graphs cost."""

    def __init__(self):
        self._graphs = {space: collections.OrderedDict() for space in MAX_GRAPHS}
        self._enable: dict = {}
        self._pool = None
        self.captures = 0
        self.capture_s = 0.0
        self.replays = 0
        self._events = None  # (space, start, end) CUDA events of each replay while timed

    def enable(self, device) -> torch.Tensor:
        """The () bool tensor every step ANDs into its ``go`` flag: True but
        while a chunk is warmed up."""
        device = torch.device(device)
        with LOCK:
            if device not in self._enable:
                self._enable[device] = torch.ones((), dtype=torch.bool, device=device)
            return self._enable[device]

    def drop(self, match: Callable[[Hashable], bool]) -> None:
        """Forget the graphs whose key ``match``es (their buffers are gone)."""
        with LOCK:
            for graphs in self._graphs.values():
                for key in [k for k in graphs if match(k)]:
                    del graphs[key]

    def run(self, key: Hashable, fn: Callable[[], None], device, *,
            generators: Iterable[torch.Generator] = (), counters: Iterable[dict] = (),
            replays: int = 1, space: str = "decode") -> None:
        """Run the step ``fn`` ``replays`` times: from its graph on a CUDA
        device (captured under ``key`` in key space ``space`` at first use),
        eagerly on the CPU or inside ``eager()``.  ``fn`` reads and writes
        only buffers that live as long as the key; ``counters`` are the
        caller's Python counters that ``fn`` bumps."""
        with LOCK:
            if torch.device(device).type != "cuda" or _EAGER[0]:
                for _ in range(replays):
                    fn()
                return
            self._replay(key, fn, torch.device(device), list(generators),
                         [*KERNEL_COUNTERS, *counters], replays, space)

    def _replay(self, key, fn, device, generators, counters, replays, space) -> None:
        graphs = self._graphs[space]
        graph = graphs.get(key)
        if graph is None:
            with span("graphs.capture", space=space):
                graph = graphs[key] = self._capture(fn, device, generators, counters)
            while len(graphs) > MAX_GRAPHS[space]:
                graphs.popitem(last=False)
        else:
            graphs.move_to_end(key)
        for _ in range(replays):
            if self._events is not None:
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
            graph.replay()
            if self._events is not None:
                end.record()
                self._events.append((space, start, end))
            self.replays += 1

    def start_timing(self) -> None:
        """Time every replay from here on with a pair of CUDA events."""
        self._events = []

    def stop_timing(self, space: str = "decode") -> float:
        """-> the device ms of the replays of key space ``space`` since
        ``start_timing``."""
        torch.cuda.synchronize()
        events, self._events = self._events or [], None
        return sum(a.elapsed_time(b) for sp, a, b in events if sp == space)

    def _capture(self, fn, device, generators, counters) -> _Graph:
        t0 = time.perf_counter()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        enable = self.enable(device)
        states = [g.get_state() for g in generators]
        with torch.cuda.stream(stream):
            enable.fill_(False)  # warm-up: every step gated off
            try:
                fn()
            finally:
                enable.fill_(True)
        stream.synchronize()
        for g, s in zip(generators, states):
            g.set_state(s)
        before = _snapshot(counters)
        graph = torch.cuda.CUDAGraph()
        for g in generators:
            graph.register_generator_state(g)
        with torch.cuda.graph(graph, pool=self._pool, stream=stream,
                              capture_error_mode="thread_local"):
            fn()
        deltas = []
        for counter, prev in zip(counters, before):
            for name, n in counter.items():
                if n != prev.get(name, 0):
                    deltas.append((counter, name, n - prev.get(name, 0)))
                    counter[name] = prev.get(name, 0)  # nothing ran
        torch.cuda.current_stream(device).wait_stream(stream)
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        return _Graph(graph, deltas)

    @property
    def pool_bytes(self) -> int:
        """Device bytes held by the segments of the graphs' private pool."""
        if self._pool is None:
            return 0
        segments = torch.cuda.memory._snapshot()["segments"]
        return sum(seg["total_size"] for seg in segments
                   if tuple(seg.get("segment_pool_id", ())) == tuple(self._pool))

    def stats(self) -> dict:
        return {"captures": self.captures, "capture_s": self.capture_s,
                "replays": self.replays,
                "graphs": sum(len(g) for g in self._graphs.values()),
                "pool_bytes": self.pool_bytes}
