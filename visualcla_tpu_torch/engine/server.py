"""Continuous-batching serving (port of visualcla_tpu/engine/server.py).

``ServingEngine`` keeps a fixed pool of B cache rows on the device, the
stacked ``(L, B, Nkv, Smax, hd)`` cache of ``models.llama``, and interleaves
requests at token granularity; its rows' control is ``pool.RowPool``'s:

- ``prefill_row`` runs one LEFT-padded prompt into a free row: the text tower
  over a one-row scratch cache at the bucket (kernel B2), the prompt's K/V
  copied into the row at a device row index, the first token sampled; one
  graph is captured per (bucket, image count and size, vision attention,
  the sampler's branch flags) and replayed for every row (``engine/graphs.py``);
- ``step_n`` advances every running row together, one token a step (kernel
  B1 at B = rows, each row at its own write slot; idle rows park on their
  ``cur_slot``, whose slot stays invalid): ``n`` replays of one captured
  gated step, stopped on the device as the JAX package's ``lax.while_loop``
  stops (n steps run, no row running, or a row finished inside the chunk);
- ``snapshot`` copies the rows' control fields to the host once.

Over a mesh (``mesh=``, the model sharded by ``parallel.sharding``) every
rank holds its kv heads of every row and runs every row: the same calls on
every rank, as ``parallel.serving`` arranges for the ``Scheduler``.

``Scheduler`` is a host thread that multiplexes a request queue onto a
``RowPool`` (this one or ``engine.paged.PagedServingEngine``), through the
contract ``RowPool`` states: a request prefills into a free row, all live
rows decode together, and a finished row is reused by the next queued
request without draining the others.  Each iteration streams every new
token to its request's queue.  Its work is recorded as spans
(``utils.profiling``) while spans are recorded: ``request`` and
``sched.queue_wait`` on the submitting thread, ``sched.admit`` /
``sched.admit_begin`` / ``sched.admit_stage``, ``sched.decode``,
``sched.snapshot``, ``sched.stream`` (``sched.release`` inside) and
``sched.idle`` on its own, each admission's carrying the request's ``rid``.
"""
from __future__ import annotations

import dataclasses
import itertools
import logging
import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..core.config import VisualCLAConfig
from ..models import llama, visualcla
from ..ops.attention import attention_mesh_scope, vision_attention_impl
from ..utils.profiling import add_span, span
from .generate import PrefillInputs
from .pool import (KNOB_NAMES, RowPool, RowState, knob_flags, knob_kwargs,  # noqa: F401
                   sampling_knobs)
from .sampling import SamplingConfig, sample_step_rowwise

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class PoolState(RowState):
    """The contiguous pool's device state: the rows' control and the cache
    (every tensor has the rows first but the cache)."""

    cache: dict  # {"k", "v"}: (L, B, Nkv, Smax, hd)
    kv_valid: torch.Tensor  # (B, Smax) bool
    cur_slot: torch.Tensor  # (B,) next cache slot a row writes


class ServingEngine(RowPool):
    """Fixed-pool continuous batching over one model (the JAX package's
    ``ServingEngine``); drives ``Scheduler``.

    ``mesh``: a ``DeviceMesh`` the model is sharded over (``bind``: done here
    if it is not yet).  The cache holds the rank's kv heads
    (``model.text.kv_heads``); rows are not split over ``data``: every rank
    runs every row, as the paged pool does.  Every admission and decode step
    runs under ``attention_mesh_scope(mesh)``.  The mesh is fixed for the
    engine and nothing of it varies from call to call, so it is not part of
    the graph keys (each engine captures its own graphs)."""

    def __init__(
        self,
        model: visualcla.VisualCLAModel,
        cfg: VisualCLAConfig,
        *,
        eos_token_id: int,
        pad_token_id: int,
        pool_size: int = 8,
        max_seq_len: int = 2048,
        max_new_tokens_cap: int = 1024,
        prompt_buckets=(128, 256, 512, 1024),
        sampling: Optional[SamplingConfig] = None,
        seed: int = 0,
        mesh=None,
    ):
        model.text.require("contiguous_pool")
        super().__init__(model, cfg, eos_token_id=eos_token_id, pad_token_id=pad_token_id,
                         pool_size=pool_size, max_seq_len=max_seq_len,
                         max_new_tokens_cap=max_new_tokens_cap, sampling=sampling, mesh=mesh)
        # every bucket leaves decode room: a prompt bucketed to Smax would
        # set cur_slot == Smax.  Buckets >= Smax are dropped; the prompts they
        # covered take bucket_len's overflow path (32-quantized lengths < Smax)
        self.prompt_buckets = tuple(b for b in prompt_buckets if b < max_seq_len)
        dev, B = self.device, self.B
        z = dict(dtype=torch.int64, device=dev)
        self._state = PoolState(
            cache=llama.init_kv_cache(cfg.text_config, B, max_seq_len, self.dtype, device=dev,
                                      kv_heads=model.text.kv_heads),
            kv_valid=torch.zeros(B, max_seq_len, dtype=torch.bool, device=dev),
            cur_slot=torch.zeros(B, **z), **self._row_fields(seed))
        # an admission's one-row scratch cache (its first L slots at bucket L),
        # its static inputs by shape, and its row, limit and knobs
        self._scratch = llama.init_kv_cache(cfg.text_config, 1, max_seq_len, self.dtype,
                                            device=dev, kv_heads=model.text.kv_heads)
        self._inputs: dict = {}
        self._row = torch.zeros(1, **z)
        self._max_new = torch.zeros(1, **z)
        self._admit_knobs = torch.zeros(11, dtype=torch.float32, device=dev)
        self._host_bucket = np.zeros(B, np.int64)

    def pool_bytes(self) -> int:
        """Device bytes of the K/V cache."""
        return sum(t.numel() * t.element_size() for t in self._state.cache.values())

    def _overflow_len(self, n: int) -> int:
        # a prompt past the buckets that fits the cache: a 32-quantized
        # length, leaving at least one decode slot
        return min(-(-n // 32) * 32, self.Smax - 1)

    # -- admission -------------------------------------------------------------

    def _prefill_step(self, inp: PrefillInputs, flags: dict) -> None:
        """One admission over static buffers only: the prompt through the text
        tower into the scratch cache, its K/V into the pool at row
        ``_row``, the first token sampled, the row's state set."""
        s, text = self._state, self.model.text
        L = inp.ids.shape[1]
        row = self._row
        embeds = visualcla.multimodal_embeds(self.model, self.cfg, inp.ids, inp.img_pos,
                                             inp.pixels)
        positions = (inp.mask.cumsum(-1) - 1).clamp(min=0)
        valid = inp.mask.bool()
        scratch = {k: v[:, :, :, :L] for k, v in self._scratch.items()}
        hidden, _ = text(embeds, positions, scratch, valid, 0)
        for name, buf in s.cache.items():
            buf[:, :, :, :L].index_copy_(1, row, scratch[name])
        s.kv_valid.index_copy_(0, row, torch.cat([valid, valid.new_zeros(1, self.Smax - L)], 1))
        logits = text.logits(hidden[:, -1:])[:, 0]  # (1, V): left padded, the last is real
        kn = self._admit_knobs[None]
        token, mu_row = sample_step_rowwise(
            logits, torch.zeros(1, self.T, dtype=torch.int64, device=self.device),
            torch.zeros(1, dtype=torch.int64, device=self.device), s.generator, self.sampling,
            **knob_kwargs(kn, 2.0 * kn[:, 7]), flags=flags)
        s.cur_slot.index_fill_(0, row, L)
        self._activate(row, token, mu_row, kn, self._max_new, positions[:, -1] + 1,
                       token == self.eos)
        self.counts["prefill_passes"] += 1

    @torch.no_grad()
    def prefill_row(self, row: int, input_ids: np.ndarray, pixel_values, img_start_pos,
                    max_new_tokens: int, overrides: Optional[dict] = None) -> None:
        """Admit one prompt (S,) into pool row ``row`` and sample its first
        token: the host pads and checks, the device work is a replay."""
        ids, mask, img_pos, pixels, _, L = self._host_prompt(input_ids, img_start_pos,
                                                             pixel_values, left=True)
        knobs = sampling_knobs(self.sampling, overrides)
        max_new = min(max_new_tokens, self.T)
        flags = knob_flags(knobs[None])
        inp = PrefillInputs.staged(self._inputs, ids, mask, img_pos, pixels, self.device,
                                   self.dtype)
        self._row.fill_(row)
        self._max_new.fill_(max_new)
        self._admit_knobs.copy_(torch.from_numpy(knobs))
        with attention_mesh_scope(self.mesh), span("admit.replay"):
            self.graphs.run(("admit", inp.key, vision_attention_impl(),
                             tuple(sorted(flags.items()))),
                            lambda: self._prefill_step(inp, flags), self.device,
                            generators=[self._state.generator], counters=[self.counts],
                            space="prefill")
        self._host_activate(row, max_new, knobs)
        self._host_bucket[row] = L

    # -- decode ----------------------------------------------------------------

    def _decode_step(self, flags: dict) -> None:
        """One gated decode step over the static buffers, in place: every
        running row writes its token's K/V at its ``cur_slot`` and attends
        (B1 in every layer), then commits the next token; rows that do not
        run write into their ``cur_slot``, which stays invalid."""
        s, text = self._state, self.model.text
        rows, Smax = self._rows, self.Smax
        run, go = self._gate()
        slot = s.cur_slot.clamp(max=Smax - 1)
        s.kv_valid[rows, slot] = s.kv_valid[rows, slot] | run
        hidden, _ = text(text.embed(s.last_token[:, None]), s.positions[:, None], s.cache,
                         s.kv_valid, slot)
        token, new_mu = sample_step_rowwise(
            text.logits(hidden)[:, 0], s.gen_ids, s.gen_len, s.generator, self.sampling,
            **knob_kwargs(s.knobs, s.mu), flags=flags)
        self._commit(run, token, new_mu, s.cur_slot)
        s.cur_slot += run.long()
        self._live += go.long()
        self.counts["decode_passes"] += 1

    @torch.no_grad()
    def step_n(self, n: int) -> None:
        """Up to ``n`` decode steps for every running row (the JAX package's
        fused ``_step_n_impl``): ``n`` replays of the captured gated step,
        stopped on the device where a row finishes inside the chunk or none
        runs; rows finished before the chunk do not stop it.  No step is
        replayed past the first running row's cap (its max_new_tokens or the
        cache's end, from the host mirrors): the loop stops there."""
        n = self._chunk_len(n, self.Smax - (self._host_bucket + self._host_gen_len - 1))
        with attention_mesh_scope(self.mesh):
            self._replay("decode", n, self._decode_step)

    def snapshot(self) -> dict:
        """The rows' control fields and the live steps run (for
        ``decode_steps``) in one device-to-host copy."""
        packed = torch.cat([self._control().reshape(-1), self._live]).cpu().numpy()
        self._count_live(packed[-1:])
        return self._read_control(packed[:-1].reshape(self.B, -1))

    def _release(self, rows: list, idx: torch.Tensor) -> None:
        self._state.kv_valid[idx] = False


@dataclasses.dataclass
class Request:
    input_ids: np.ndarray
    pixel_values: Optional[np.ndarray]
    img_start_pos: Optional[int]
    max_new_tokens: int
    out: "queue.Queue"  # receives ('token', id) ... then ('done', ids) or ('error', msg)
    sampling_overrides: Optional[dict] = None  # per-request knobs (KNOB_NAMES)
    # set by Scheduler.submit: the request's id, when (time.time_ns) and on
    # which OS thread it was submitted; when its first token was put
    rid: int = 0
    t_submit_ns: int = 0
    submit_tid: int = 0
    t_first_ns: int = 0

    def close(self, kind: str, payload) -> None:
        """Put the request's last item, ('done', ids) or ('error', msg), and
        record its ``request`` span (submit to now, on the submitting
        thread)."""
        self.out.put((kind, payload))
        add_span("request", self.t_submit_ns, time.time_ns(), rid=self.rid, tid=self.submit_tid,
                 first_token_ns=self.t_first_ns or None, end=kind)


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
        self._rids = itertools.count(1)
        # wall-clock attribution of the loop (seconds / counts), via stats();
        # t_queue_wait sums submit -> admission start over the admissions
        # started (prefills + chunked_admissions)
        self._stats = {
            "prefills": 0, "chunked_admissions": 0, "prefill_chunks": 0,
            "chunk_dispatches": 0, "spec_dispatches": 0, "idle_sleeps": 0,
            "t_prefill": 0.0, "t_snapshot": 0.0, "t_stream": 0.0, "t_queue_wait": 0.0,
        }
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def stats(self) -> dict:
        """A copy of the loop's counters."""
        return dict(self._stats)

    def submit(self, req: Request) -> None:
        req.rid = next(self._rids)
        req.t_submit_ns = time.time_ns()
        req.submit_tid = threading.get_native_id()
        if self._crash is not None:
            req.close("error", self._crash)  # nothing will drain the queue
            return
        self.requests.put(req)
        if self._crash is not None:
            # the crash handler's drain may have raced this put: drain again
            while True:
                try:
                    self.requests.get_nowait().close("error", self._crash)
                except queue.Empty:
                    break

    def stop(self) -> None:
        """Stop the loop; over a mesh (``parallel.serving.Leader``) the other
        ranks' ``follow`` then returns."""
        self._stop.set()
        self.thread.join(timeout=30)
        self.engine.release_followers()

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
                preq.close("error", msg)
                self._pending = None
            for req, _ in self._rows.values():
                req.close("error", msg)
            self._rows.clear()
            while True:
                try:
                    self.requests.get_nowait().close("error", msg)
                except queue.Empty:
                    break
            # last: a broadcast to ranks that already died blocks until the
            # group's timeout, and no waiter should wait for it
            try:  # over a mesh the other ranks' follow raises with the message
                self.engine.release_followers(msg)
            except Exception:  # noqa: BLE001 — a lost rank cannot be told
                logger.exception("releasing the following ranks failed")

    def _queue_wait(self, req: Request, t_ns: int) -> None:
        """An admission of ``req`` started at ``t_ns``: its time in the queue."""
        self._stats["t_queue_wait"] += (t_ns - req.t_submit_ns) * 1e-9
        add_span("sched.queue_wait", req.t_submit_ns, t_ns, rid=req.rid, tid=req.submit_tid)

    def _run_inner(self):
        eng = self.engine
        st = self._stats
        deferred = None  # a request waiting for KV blocks
        self._pending = None  # (PendingPrefill, row, Request)
        while not self._stop.is_set():
            did_work = False
            # advance the in-flight chunked admission by one stage
            if self._pending is not None:
                pp, prow, preq = self._pending
                t0 = time.time_ns()
                done = False
                try:
                    chunk_before = pp.i
                    done = pp.step()
                    t1 = time.time_ns()
                    st["prefill_chunks"] += pp.i - chunk_before
                    st["t_prefill"] += (t1 - t0) * 1e-9
                    if done:
                        self._rows[prow] = [preq, 0]
                        self._pending = None
                except Exception as e:  # noqa: BLE001 — isolate the request
                    t1 = time.time_ns()
                    logger.exception("chunked prefill failed for a request")
                    preq.close("error", str(e))
                    self._pending = None  # abort() returned the blocks
                add_span("sched.admit_stage", t0, t1, rid=preq.rid, stage=pp.i, done=done)
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
                    req.close("error", "request exceeds the engine's KV pool")
                    continue
                # ADAPTIVE admission: chunked admission bounds the live rows'
                # stalls but admits one request at a time, so it is used only
                # while the queue is shallow; a backlog drains with one-shot
                # prefills
                backlog = self.requests.qsize() + (deferred is not None)
                wants_chunked = (eng.chunked_admission and self.prefill_chunk > 0
                                 and (self._rows or self._pending is not None)
                                 and backlog <= self.chunked_backlog_limit
                                 and len(req.input_ids) > self.prefill_chunk)
                if wants_chunked and self._pending is not None:
                    deferred = req  # one chunked admission at a time
                    break
                t0 = time.time_ns()
                if wants_chunked:
                    try:
                        self._pending = (eng.begin_prefill(
                            row, req.input_ids, req.pixel_values, req.img_start_pos,
                            req.max_new_tokens, overrides=req.sampling_overrides,
                            chunk=self.prefill_chunk), row, req)
                        st["chunked_admissions"] += 1
                    except Exception as e:  # noqa: BLE001
                        logger.exception("begin_prefill failed for a request")
                        req.close("error", str(e))
                        continue
                    finally:
                        add_span("sched.admit_begin", t0, time.time_ns(), rid=req.rid)
                    self._queue_wait(req, t0)
                    did_work = True
                    break
                try:
                    eng.prefill_row(row, req.input_ids, req.pixel_values, req.img_start_pos,
                                    req.max_new_tokens, overrides=req.sampling_overrides)
                except Exception as e:  # noqa: BLE001 — isolate the request
                    logger.exception("prefill failed for a request")
                    req.close("error", str(e))
                    continue
                finally:
                    t1 = time.time_ns()
                    add_span("sched.admit", t0, t1, rid=req.rid)
                st["t_prefill"] += (t1 - t0) * 1e-9
                st["prefills"] += 1
                self._queue_wait(req, t0)
                self._rows[row] = [req, 0]
                did_work = True
            if self._rows:
                # several steps a dispatch unless an admission could happen
                # now: in every other state admission waits for a row to
                # FINISH, which step_n's early exit catches
                nothing_waiting = deferred is None and self.requests.empty()
                pool_full = len(self._rows) >= eng.B
                block_bound = deferred is not None
                t0 = time.time_ns()
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
                t1 = time.time_ns()
                snap = eng.snapshot()
                t2 = time.time_ns()
                add_span("sched.decode", t0, t1)
                add_span("sched.snapshot", t1, t2)
                st["t_snapshot"] += (t2 - t1) * 1e-9
                retiring = []  # (row, Request, ids), released as one batch
                for row in list(self._rows):
                    req, emitted = self._rows[row]
                    gl = int(snap["gen_len"][row])
                    if gl > emitted:
                        # every token since the last snapshot; emitted starts
                        # at 0, so the prefill's first token goes out too
                        if emitted == 0:
                            req.t_first_ns = time.time_ns()
                        for tok in snap["gen_ids"][row][emitted:gl]:
                            req.out.put(("token", int(tok)))
                        self._rows[row][1] = gl
                    if bool(snap["finished"][row]):
                        retiring.append((row, req, np.array(snap["gen_ids"][row][:gl])))
                if retiring:
                    with span("sched.release"):
                        eng.release_rows([row for row, _, _ in retiring])
                    for row, req, ids in retiring:
                        req.close("done", ids)
                        del self._rows[row]
                t3 = time.time_ns()
                add_span("sched.stream", t2, t3)
                st["t_stream"] += (t3 - t2) * 1e-9
                did_work = True
            if not did_work:
                st["idle_sleeps"] += 1
                with span("sched.idle"):
                    eng.idle()  # over a mesh: the leader's heartbeat
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
