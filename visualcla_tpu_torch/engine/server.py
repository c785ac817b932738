"""Continuous-batching scheduler (port of visualcla_tpu/engine/server.py).

A host thread multiplexes a request queue onto a pool of cache rows
(``engine.paged.PagedServingEngine``): a request prefills into a free row,
all live rows advance together one token a decode step, and a finished row is
reused by the next queued request without draining the others.  Each
iteration copies the rows' control fields to the host once (``snapshot``) and
streams every new token to its request's queue.

The JAX package's contiguous-pool ``ServingEngine`` is not ported yet
(ROADMAP, open item 12); the scheduler drives the paged engine.
"""
from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from .sampling import SamplingConfig

logger = logging.getLogger(__name__)

KNOB_NAMES = ("temperature", "top_p", "repetition_penalty", "do_sample", "tfs", "top_a",
              "mirostat_mode", "mirostat_tau", "mirostat_eta", "top_k",
              "no_repeat_ngram_size")


def _check_serving_sampling(s: SamplingConfig) -> SamplingConfig:
    """The pool samples with ``sample_step_rowwise``, which covers the
    reference's whole sampler surface per row; only unknown mirostat modes
    are refused."""
    if s.mirostat_mode not in (0, 2):
        raise ValueError(f"mirostat_mode={s.mirostat_mode} is not a thing (the reference "
                         "implements mirostat v2 only; use mirostat_mode=2)")
    return s


def sampling_knobs(sampling: SamplingConfig, overrides: Optional[dict]) -> np.ndarray:
    """A request's knob vector, (11,) f32 in ``KNOB_NAMES`` order (do_sample
    as 0/1), from its overrides over the engine-wide defaults."""
    o = overrides or {}
    mode = int(o.get("mirostat_mode", sampling.mirostat_mode))
    if mode not in (0, 2):
        raise ValueError(f"mirostat_mode={mode} unsupported (0 or 2)")
    return np.asarray([
        float(o.get("temperature", sampling.temperature)),
        float(o.get("top_p", sampling.top_p)),
        float(o.get("repetition_penalty", sampling.repetition_penalty)),
        1.0 if o.get("do_sample", sampling.do_sample) else 0.0,
        float(o.get("tfs", sampling.tfs)),
        float(o.get("top_a", sampling.top_a)),
        float(mode),
        float(o.get("mirostat_tau", sampling.mirostat_tau)),
        float(o.get("mirostat_eta", sampling.mirostat_eta)),
        float(o.get("top_k", sampling.top_k)),
        float(o.get("no_repeat_ngram_size", sampling.no_repeat_ngram_size)),
    ], np.float32)


def knob_kwargs(knobs: torch.Tensor, mu: torch.Tensor) -> dict:
    """``sample_step_rowwise`` keyword arguments from (B, 11) device knobs
    and the rows' mirostat state."""
    return dict(
        temperature=knobs[:, 0], top_p=knobs[:, 1], repetition_penalty=knobs[:, 2],
        do_sample=knobs[:, 3] > 0.5, tfs=knobs[:, 4], top_a=knobs[:, 5],
        mirostat=knobs[:, 6] > 1.5, miro_tau=knobs[:, 7], miro_eta=knobs[:, 8], mu=mu,
        top_k=knobs[:, 9].long(), ngram=knobs[:, 10].long())


@dataclasses.dataclass
class Request:
    input_ids: np.ndarray
    pixel_values: Optional[np.ndarray]
    img_start_pos: Optional[int]
    max_new_tokens: int
    out: "queue.Queue"  # receives ('token', id) ... then ('done', ids) or ('error', msg)
    sampling_overrides: Optional[dict] = None  # per-request knobs (KNOB_NAMES)


class Scheduler:
    """Host thread multiplexing a request queue onto the pool."""

    def __init__(self, engine, poll_interval: float = 0.0, step_chunk: int = 8,
                 prefill_chunk: int = 256, chunked_backlog_limit: int = 1):
        self.engine = engine
        self.requests: queue.Queue = queue.Queue()
        self.poll_interval = poll_interval
        # with no admission pending, decode up to this many steps a dispatch
        # (engine.step_n): bounds the added streaming / admission latency
        self.step_chunk = max(1, int(step_chunk))
        # CHUNKED PREFILL: prompts longer than this admit in prefill_chunk-
        # token stages (engine.begin_prefill) with decode steps for the live
        # rows between them; 0 disables
        self.prefill_chunk = max(0, int(prefill_chunk))
        # chunk only while the waiting queue is at most this deep (below)
        self.chunked_backlog_limit = int(chunked_backlog_limit)
        self._rows: dict = {}  # row -> [Request, emitted_count]
        self._pending = None  # in-flight chunked admission
        self._stop = threading.Event()
        self._crash: Optional[str] = None  # set when the loop dies
        # wall-clock attribution of the loop (seconds / counts), via stats()
        self._stats = {
            "iterations": 0, "prefills": 0, "chunked_admissions": 0, "prefill_chunks": 0,
            "chunk_dispatches": 0, "spec_dispatches": 0, "single_steps": 0, "idle_sleeps": 0,
            "collects": 0,
            "t_prefill": 0.0, "t_step": 0.0, "t_snapshot": 0.0, "t_collect": 0.0,
            "t_stream": 0.0,
        }
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def stats(self) -> dict:
        """A copy of the loop's counters."""
        return dict(self._stats)

    def submit(self, req: Request) -> None:
        if self._crash is not None:
            req.out.put(("error", self._crash))  # nothing will drain the queue
            return
        self.requests.put(req)
        if self._crash is not None:
            # the crash handler's drain may have raced this put: drain again
            while True:
                try:
                    self.requests.get_nowait().out.put(("error", self._crash))
                except queue.Empty:
                    break

    def stop(self) -> None:
        self._stop.set()
        self.thread.join(timeout=30)

    def _free_rows(self):
        return [r for r in range(self.engine.B) if r not in self._rows]

    def _run(self):
        try:
            with torch.no_grad():
                self._run_inner()
        except Exception as e:  # noqa: BLE001 — a dead loop must fail every waiter
            logger.exception("scheduler loop died; failing all requests")
            msg = f"scheduler loop died: {e}"
            self._crash = msg  # submit() fails fast from now on
            self._stop.set()
            if self._pending is not None:
                pp, _, preq = self._pending
                try:
                    pp.abort()
                except Exception:  # noqa: BLE001 — the engine may be unusable
                    logger.exception("aborting pending admission failed")
                preq.out.put(("error", msg))
                self._pending = None
            for req, _ in self._rows.values():
                req.out.put(("error", msg))
            self._rows.clear()
            while True:
                try:
                    self.requests.get_nowait().out.put(("error", msg))
                except queue.Empty:
                    break

    def _run_inner(self):
        eng = self.engine
        st = self._stats
        deferred = None  # a request waiting for KV blocks
        self._pending = None  # (PendingPrefill, row, Request)
        while not self._stop.is_set():
            st["iterations"] += 1
            did_work = False
            # advance the in-flight chunked admission by one stage
            if self._pending is not None:
                pp, prow, preq = self._pending
                try:
                    t0 = time.perf_counter()
                    chunk_before = pp.i
                    done = pp.step()
                    st["prefill_chunks"] += pp.i - chunk_before
                    st["t_prefill"] += time.perf_counter() - t0
                    if done:
                        self._rows[prow] = [preq, 0]
                        self._pending = None
                except Exception as e:  # noqa: BLE001 — isolate the request
                    logger.exception("chunked prefill failed for a request")
                    preq.out.put(("error", str(e)))
                    self._pending = None  # abort() returned the blocks
                did_work = True
            # admit queued requests into free rows
            for row in self._free_rows():
                if self._pending is not None and row == self._pending[1]:
                    continue  # mid-admission row: allocated, not yet live
                if deferred is not None:
                    req, deferred = deferred, None
                else:
                    try:
                        req = self.requests.get_nowait()
                    except queue.Empty:
                        break
                if not eng.can_admit(len(req.input_ids)):
                    if self._rows or self._pending is not None:
                        deferred = req  # blocks free up as rows finish
                        break
                    req.out.put(("error", "request exceeds the engine's KV pool"))
                    continue
                # ADAPTIVE admission: chunked admission bounds the live rows'
                # stalls but admits one request at a time, so it is used only
                # while the queue is shallow; a backlog drains with one-shot
                # prefills
                backlog = self.requests.qsize() + (deferred is not None)
                wants_chunked = (self.prefill_chunk > 0
                                 and (self._rows or self._pending is not None)
                                 and backlog <= self.chunked_backlog_limit
                                 and len(req.input_ids) > self.prefill_chunk)
                if wants_chunked and self._pending is not None:
                    deferred = req  # one chunked admission at a time
                    break
                if wants_chunked:
                    try:
                        self._pending = (eng.begin_prefill(
                            row, req.input_ids, req.pixel_values, req.img_start_pos,
                            req.max_new_tokens, overrides=req.sampling_overrides,
                            chunk=self.prefill_chunk), row, req)
                        st["chunked_admissions"] += 1
                    except Exception as e:  # noqa: BLE001
                        logger.exception("begin_prefill failed for a request")
                        req.out.put(("error", str(e)))
                        continue
                    did_work = True
                    break
                try:
                    t0 = time.perf_counter()
                    eng.prefill_row(row, req.input_ids, req.pixel_values, req.img_start_pos,
                                    req.max_new_tokens, overrides=req.sampling_overrides)
                    st["t_prefill"] += time.perf_counter() - t0
                    st["prefills"] += 1
                except Exception as e:  # noqa: BLE001 — isolate the request
                    logger.exception("prefill failed for a request")
                    req.out.put(("error", str(e)))
                    continue
                self._rows[row] = [req, 0]
                did_work = True
            if self._rows:
                # several steps a dispatch unless an admission could happen
                # now: in every other state admission waits for a row to
                # FINISH, which step_n's early exit catches
                nothing_waiting = deferred is None and self.requests.empty()
                pool_full = len(self._rows) >= eng.B
                block_bound = deferred is not None
                t0 = time.perf_counter()
                if (self.step_chunk > 1 and self._pending is None
                        and (nothing_waiting or pool_full or block_bound)):
                    # at low occupancy, speculative iterations commit up to
                    # spec_k+1 tokens a greedy row for about one step's
                    # weight reads; only when some running row can accept
                    # drafts (an ineligible row commits one token either way)
                    if len(self._rows) <= eng.spec_max_active and eng.spec_ready():
                        eng.spec_step_n(self.step_chunk)
                        st["spec_dispatches"] += 1
                    else:
                        eng.step_n(self.step_chunk)
                        st["chunk_dispatches"] += 1
                else:
                    eng.step()
                    st["single_steps"] += 1
                t1 = time.perf_counter()
                snap = eng.snapshot()
                t2 = time.perf_counter()
                st["t_step"] += t1 - t0
                st["t_snapshot"] += t2 - t1
                retiring = []  # (row, Request, ids), released as one batch
                for row in list(self._rows):
                    req, emitted = self._rows[row]
                    gl = int(snap["gen_len"][row])
                    if gl > emitted:
                        # every token since the last snapshot; emitted starts
                        # at 0, so the prefill's first token goes out too
                        for tok in snap["gen_ids"][row][emitted:gl]:
                            req.out.put(("token", int(tok)))
                        self._rows[row][1] = gl
                    if bool(snap["finished"][row]):
                        retiring.append((row, req, np.array(snap["gen_ids"][row][:gl])))
                if retiring:
                    t3 = time.perf_counter()
                    eng.release_rows([row for row, _, _ in retiring])
                    st["t_collect"] += time.perf_counter() - t3
                    st["collects"] += len(retiring)
                    for row, req, ids in retiring:
                        req.out.put(("done", ids))
                        del self._rows[row]
                st["t_stream"] += time.perf_counter() - t2
                did_work = True
            if not did_work:
                st["idle_sleeps"] += 1
                time.sleep(self.poll_interval or 0.005)


def _submit(scheduler: Scheduler, input_ids, pixel_values, img_start_pos, max_new_tokens,
            sampling_overrides) -> "queue.Queue":
    q: queue.Queue = queue.Queue()
    scheduler.submit(Request(
        input_ids=np.asarray(input_ids), pixel_values=pixel_values,
        img_start_pos=img_start_pos, max_new_tokens=max_new_tokens, out=q,
        sampling_overrides=sampling_overrides))
    return q


def _next(q: "queue.Queue", deadline: float, timeout: float):
    try:
        return q.get(timeout=max(0.0, deadline - time.time()))
    except queue.Empty:
        raise RuntimeError(f"serving request timed out after {timeout}s") from None


def generate_sync(scheduler: Scheduler, input_ids, pixel_values=None, img_start_pos=None,
                  max_new_tokens: int = 512, sampling_overrides: Optional[dict] = None,
                  timeout: float = 600.0) -> np.ndarray:
    """Submit one request and wait for its generated ids."""
    q = _submit(scheduler, input_ids, pixel_values, img_start_pos, max_new_tokens,
                sampling_overrides)
    deadline = time.time() + timeout
    while True:
        kind, payload = _next(q, deadline, timeout)
        if kind == "done":
            return payload
        if kind == "error":
            raise RuntimeError(payload)


def generate_stream(scheduler: Scheduler, input_ids, pixel_values=None, img_start_pos=None,
                    max_new_tokens: int = 512, sampling_overrides: Optional[dict] = None,
                    timeout: float = 600.0):
    """Submit one request; yield ('token', id) as the pool produces each
    token, then ('done', ids).  Raises on a scheduler error or the timeout.
    Safe under concurrent callers: each request has its own queue."""
    q = _submit(scheduler, input_ids, pixel_values, img_start_pos, max_new_tokens,
                sampling_overrides)
    deadline = time.time() + timeout
    while True:
        kind, payload = _next(q, deadline, timeout)
        if kind == "token":
            yield "token", int(payload)
        elif kind == "done":
            yield "done", payload
            return
        elif kind == "error":
            raise RuntimeError(payload)
