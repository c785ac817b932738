"""Serving a meshed model at world size > 1: rank 0's ``Scheduler`` leads,
the other ranks follow.

The port runs one process per device (explicit SPMD), and every forward pass
of a meshed model runs the mesh's collectives, so every rank must make the
same engine calls in the same order.  The JAX package's single controller
gets that for free; here rank 0's ``engine.server.Scheduler`` drives its pool
through a ``Leader``, a proxy that implements the Scheduler's contract
(``engine.pool.RowPool``'s) and broadcasts each call that launches device
work or changes host state the ranks share before it makes it:
``prefill_row``, ``begin_prefill`` and each ``PendingPrefill.step`` /
``abort``, ``step`` / ``step_n`` / ``spec_step_n`` and ``release_rows``.
Every other rank runs ``follow(engine, group)``, which makes the same calls
in the same order until the stop message.  Host reads without a collective
(``snapshot``, ``num_active``, ``can_admit``, ``spec_ready``) stay on rank
0; a follower repeats only the host mirrors a ``snapshot`` refreshes,
flagged on the next message, so both ranks' ``step_n`` cap their chunks
alike.  ``apps.serve.PoolWorker`` decides who leads and builds the group.

The channel is a gloo group of its own beside the model's (NCCL on the card):
the messages are host objects (a call's name, its ids, pixels and knobs),
pickled by ``broadcast_object_list``, and one channel keeps them in order.
Pixels go with them: a 224 px image is 0.6 MB of f32, small beside the
admission it feeds, and NCCL would need them on the card first and a second
channel ordered with the first.  The group's timeout is the followers'
deadline: a follower that hears nothing for ``deadline_s`` raises.  While
the leader's loop idles it sends a heartbeat every ``deadline_s / 4``
(``Scheduler`` calls ``idle``); ``Scheduler.stop`` sends the stop message and
its crash handler a crash message, on which every follower raises.

Every rank's engine must be built with the same ``seed``, so that sampled
rows draw the same noise everywhere.
"""
from __future__ import annotations

import itertools
import logging
import threading
import time
from datetime import timedelta
from typing import Optional

import torch

from . import distributed

logger = logging.getLogger(__name__)

DEADLINE_S = 600.0  # a follower's wait for the next message (the group's timeout)
LEADER = 0
# the Scheduler's engine calls a follower repeats; the others are reads on rank 0
CALLS = ("prefill_row", "step", "step_n", "spec_step_n", "release_rows")
# calls whose failure the Scheduler isolates to one request: a follower's
# identical failure is logged and the loop goes on, as the leader's does
ISOLATED = ("prefill_row", "begin_prefill", "pp_step")


def control_group(deadline_s: float = DEADLINE_S):
    """The gloo group the leader's messages travel on, its timeout the
    followers' deadline.  Collective: every rank calls it, in the same order
    as its other group creations."""
    import torch.distributed as dist

    return dist.new_group(backend="gloo", timeout=timedelta(seconds=deadline_s))


def _host(obj):
    """``obj`` with any torch tensor moved to the host (the message is pickled)."""
    if isinstance(obj, torch.Tensor):
        return obj.cpu()
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    return obj


def _broadcast(name: str):
    """A ``Leader`` method for the call ``name``: broadcast, then made."""
    def call(self, *args, **kwargs):
        self._send("call", (name, args, kwargs))
        return getattr(self._engine, name)(*args, **kwargs)

    call.__name__ = name
    return call


class Leader:
    """Rank 0's proxy over its engine: each member the ``Scheduler`` calls is
    its own (the calls in ``CALLS`` and ``begin_prefill`` are broadcast, then
    made); the engine's attributes (``B``, ``counts``, ``graphs``, ...) are
    read through."""

    def __init__(self, engine, group, deadline_s: float = DEADLINE_S):
        self._engine = engine
        self._group = group
        self._heartbeat_s = deadline_s / 4
        self._lock = threading.Lock()  # one message at a time, whichever thread sends
        self._snapped = False  # a snapshot was taken since the last message
        self._last = time.monotonic()
        self._handles = itertools.count()
        self._released = False
        self.messages = 0

    def _send(self, op: str, payload=None) -> None:
        import torch.distributed as dist

        with self._lock:
            if self._released:
                raise RuntimeError("the following ranks were released; the pool is closed")
            msg = [(op, self._snapped, _host(payload))]
            self._snapped = False
            dist.broadcast_object_list(msg, src=LEADER, group=self._group)
            self._last = time.monotonic()
            self.messages += 1

    def __getattr__(self, name):
        return getattr(self._engine, name)

    prefill_row, step, step_n, spec_step_n, release_rows = map(_broadcast, CALLS)

    def snapshot(self):
        snap = self._engine.snapshot()
        self._snapped = True
        return snap

    def begin_prefill(self, *args, **kwargs):
        handle = next(self._handles)
        self._send("begin", (handle, args, kwargs))
        return _Pending(self, handle, self._engine.begin_prefill(*args, **kwargs))

    def can_admit(self, prompt_len: int) -> bool:
        return self._engine.can_admit(prompt_len)

    def spec_ready(self) -> bool:
        return self._engine.spec_ready()

    def idle(self) -> None:
        """A heartbeat, if nothing went out for a quarter of the deadline."""
        if time.monotonic() - self._last >= self._heartbeat_s:
            self._send("ping")

    def release_followers(self, error: Optional[str] = None) -> None:
        """The last message: the followers' ``follow`` returns, or raises with
        ``error`` (the leader's loop died).  Later calls do nothing."""
        if self._released:
            return
        try:
            self._send("crash" if error is not None else "stop", error)
        finally:
            self._released = True


class _Pending:
    """A chunked admission on the leader: ``step`` and ``abort`` broadcast
    first; its other attributes are the ``PendingPrefill``'s."""

    def __init__(self, leader: Leader, handle: int, pending):
        self._leader, self._handle, self._pending = leader, handle, pending

    def step(self) -> bool:
        self._leader._send("pp_step", self._handle)
        return self._pending.step()

    def abort(self) -> None:
        self._leader._send("pp_abort", self._handle)
        self._pending.abort()

    def __getattr__(self, name):
        return getattr(self._pending, name)


def follow(engine, group, deadline_s: float = DEADLINE_S) -> dict:
    """Make the leader's engine calls on this rank's ``engine``, in its
    order, until it stops: -> counts of the calls made.  Raises
    ``TimeoutError`` when no message comes for ``deadline_s`` (the group's
    timeout: pass the one ``group`` was made with) and ``RuntimeError`` when
    the leader's loop died."""
    import torch.distributed as dist

    if distributed.rank() == LEADER:
        raise RuntimeError(f"rank {LEADER} leads (a Leader under its Scheduler); "
                           "follow runs on the other ranks")
    pending = {}
    counts = {"messages": 0, "failed": 0}
    while True:
        box = [None]
        try:
            dist.broadcast_object_list(box, src=LEADER, group=group)
        except RuntimeError as e:
            raise TimeoutError(f"no message from rank {LEADER} within the {deadline_s} s "
                               f"deadline: {e}") from e
        op, snapped, payload = box[0]
        counts["messages"] += 1
        if snapped:
            engine.snapshot()  # the leader's host mirrors, from the same device state
        if op == "stop":
            return counts
        if op == "crash":
            raise RuntimeError(f"rank {LEADER}'s scheduler died: {payload}")
        if op == "ping":
            continue
        name = payload[0] if op == "call" else {"begin": "begin_prefill"}.get(op, op)
        counts[name] = counts.get(name, 0) + 1
        try:
            if op == "call":
                _, args, kwargs = payload
                getattr(engine, name)(*args, **kwargs)
            elif op == "begin":
                handle, args, kwargs = payload
                pending[handle] = engine.begin_prefill(*args, **kwargs)
            elif op == "pp_step":
                if pending[payload].step():
                    del pending[payload]
            elif op == "pp_abort":
                pending.pop(payload).abort()
            else:
                raise RuntimeError(f"unknown message {op!r} from rank {LEADER}")
        except Exception:
            if name not in ISOLATED:
                raise
            if op == "pp_step":
                pending.pop(payload, None)  # PendingPrefill.step aborted itself
            counts["failed"] += 1
            logger.exception("a call failed here as on rank %d: %s", LEADER, name)
