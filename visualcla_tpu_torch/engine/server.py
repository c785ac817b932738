"""Continuous-batching serving (port of visualcla_tpu/engine/server.py).

``ServingEngine`` keeps a fixed pool of B cache rows on the device, the
stacked ``(L, B, Nkv, Smax, hd)`` cache of ``models.llama``, and interleaves
requests at token granularity:

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

``Scheduler`` is a host thread that multiplexes a request queue onto the pool
of either engine (this one or ``engine.paged.PagedServingEngine``, whose
extra entry points it reaches through ``getattr``): a request prefills into
a free row, all live rows decode together, and a finished row is reused by
the next queued request without draining the others.  Each iteration streams
every new token to its request's queue.  Its work is recorded as spans
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
import torch.nn.functional as F

from ..core.config import VisualCLAConfig
from ..models import llama, visualcla
from ..ops.attention import attention_mesh_scope, vision_attention_impl
from ..parallel.sharding import bind
from ..utils.profiling import add_span, span
from .generate import PrefillInputs, host_pixels, pick_bucket
from .graphs import Graphs
from .sampling import SamplingConfig, rowwise_flags, sample_step_rowwise

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


def knob_flags(knobs: np.ndarray) -> dict:
    """``rowwise_flags`` from host knob rows (B', 11) (``sampling_knobs``)."""
    return rowwise_flags(top_p=knobs[:, 1], repetition_penalty=knobs[:, 2],
                         do_sample=knobs[:, 3] > 0.5, tfs=knobs[:, 4], top_a=knobs[:, 5],
                         mirostat=knobs[:, 6] > 1.5, top_k=knobs[:, 9], ngram=knobs[:, 10])


@dataclasses.dataclass
class PoolState:
    """The contiguous pool's device state (every tensor has the rows first
    but the cache)."""

    cache: dict  # {"k", "v"}: (L, B, Nkv, Smax, hd)
    kv_valid: torch.Tensor  # (B, Smax) bool
    cur_slot: torch.Tensor  # (B,) next cache slot a row writes
    positions: torch.Tensor  # (B,) next rope position
    last_token: torch.Tensor  # (B,)
    gen_ids: torch.Tensor  # (B, T)
    gen_len: torch.Tensor  # (B,)
    max_len: torch.Tensor  # (B,) per-request max_new_tokens
    active: torch.Tensor  # (B,) bool
    finished: torch.Tensor  # (B,) bool: hit EOS or a limit, awaiting collection
    mu: torch.Tensor  # (B,) f32 mirostat state
    knobs: torch.Tensor  # (B, 11) f32 per-request knobs (sampling_knobs)
    generator: torch.Generator


class ServingEngine:
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
        bind(model, mesh)
        self.mesh = mesh
        self.model = model
        self.cfg = cfg
        self.eos = eos_token_id
        self.pad = pad_token_id
        self.B = pool_size
        self.Smax = max_seq_len
        self.T = max_new_tokens_cap
        # every bucket leaves decode room: a prompt bucketed to Smax would
        # set cur_slot == Smax.  Buckets >= Smax are dropped; the prompts they
        # covered take bucket_len's overflow path (32-quantized lengths < Smax)
        self.prompt_buckets = tuple(b for b in prompt_buckets if b < max_seq_len)
        self.sampling = _check_serving_sampling(sampling or SamplingConfig())
        p = model.text.final_norm.weight  # a float leaf at every weight tier
        self.device, self.dtype = p.device, p.dtype
        dev, B, T = self.device, self.B, self.T
        default_knobs = sampling_knobs(self.sampling, None)
        z = dict(dtype=torch.int64, device=dev)
        self._state = PoolState(
            cache=llama.init_kv_cache(cfg.text_config, B, max_seq_len, self.dtype, device=dev,
                                      kv_heads=model.text.kv_heads),
            kv_valid=torch.zeros(B, max_seq_len, dtype=torch.bool, device=dev),
            cur_slot=torch.zeros(B, **z), positions=torch.zeros(B, **z),
            last_token=torch.zeros(B, **z), gen_ids=torch.zeros(B, T, **z),
            gen_len=torch.zeros(B, **z), max_len=torch.zeros(B, **z),
            active=torch.zeros(B, dtype=torch.bool, device=dev),
            finished=torch.zeros(B, dtype=torch.bool, device=dev),
            mu=torch.full((B,), 2.0 * self.sampling.mirostat_tau, device=dev),
            knobs=torch.as_tensor(np.tile(default_knobs, (B, 1)), device=dev),
            generator=torch.Generator(device=dev).manual_seed(seed))
        # an admission's one-row scratch cache (its first L slots at bucket L),
        # its static inputs by shape, and its row, limit and knobs
        self._scratch = llama.init_kv_cache(cfg.text_config, 1, max_seq_len, self.dtype,
                                            device=dev, kv_heads=model.text.kv_heads)
        self._inputs: dict = {}
        self._row = torch.zeros(1, **z)
        self._max_new = torch.zeros(1, **z)
        self._admit_knobs = torch.zeros(11, dtype=torch.float32, device=dev)
        # the decode chunk's static inputs: the finished flags at its start,
        # and the live (ungated) steps run so far
        self._finished0 = torch.zeros(B, dtype=torch.bool, device=dev)
        self._live = torch.zeros(1, **z)
        self._live_host = 0
        self._rows = torch.arange(B, device=dev)
        # host mirrors: active is host-driven; the rest as of the last snapshot
        self._host_active = np.zeros(B, bool)
        self._host_finished = np.zeros(B, bool)
        self._host_gen_len = np.zeros(B, np.int64)
        self._host_max_len = np.zeros(B, np.int64)
        self._host_bucket = np.zeros(B, np.int64)
        self._host_knobs = np.tile(default_knobs, (B, 1))
        self.decode_steps = 0  # live decode steps run (counts["decode_passes"]: all)
        self.graphs = Graphs()
        # forward passes run on the device, gated ones included: a decode
        # pass launches B1 once a layer, an admission B2 once a layer; the
        # live (ungated) decode passes as of the last snapshot
        self.counts = {"decode_passes": 0, "prefill_passes": 0, "live_decode_passes": 0}

    def pool_bytes(self) -> int:
        """Device bytes of the K/V cache."""
        return sum(t.numel() * t.element_size() for t in self._state.cache.values())

    def bucket_len(self, n: int) -> int:
        try:
            return pick_bucket(self.prompt_buckets, n)
        except ValueError:
            # overflow path: the prompt fits no bucket but does fit the cache:
            # a 32-quantized length, leaving at least one decode slot
            L = min(-(-n // 32) * 32, self.Smax - 1)
            if n <= L:
                return L
            raise

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
        s.positions.index_copy_(0, row, positions[:, -1] + 1)
        s.last_token.index_copy_(0, row, token)
        s.gen_ids.index_copy_(0, row, F.pad(token[:, None], (0, self.T - 1)))
        s.gen_len.index_fill_(0, row, 1)
        s.max_len.index_copy_(0, row, self._max_new)
        s.active.index_fill_(0, row, True)
        s.finished.index_copy_(0, row, token == self.eos)
        s.mu.index_copy_(0, row, mu_row)
        s.knobs.index_copy_(0, row, kn)
        self.counts["prefill_passes"] += 1

    @torch.no_grad()
    def prefill_row(self, row: int, input_ids: np.ndarray, pixel_values, img_start_pos,
                    max_new_tokens: int, overrides: Optional[dict] = None) -> None:
        """Admit one prompt (S,) into pool row ``row`` and sample its first
        token: the host pads and checks, the device work is a replay."""
        input_ids = np.asarray(input_ids, np.int64).reshape(-1)
        S = len(input_ids)
        L = self.bucket_len(S)
        ids = np.full((1, L), self.pad, np.int64)
        mask = np.zeros((1, L), np.int64)
        ids[0, L - S:] = input_ids
        mask[0, L - S:] = 1
        if img_start_pos is not None and np.ndim(img_start_pos) > 0:
            # multi-image: (K,) markers, shifted by the left padding; -1 stays
            ip = np.asarray(img_start_pos, np.int64).reshape(1, -1)
            img_pos = np.where(ip < 0, -1, ip + (L - S))
        else:
            img_pos = np.asarray([-1 if img_start_pos is None or img_start_pos < 0
                                  else img_start_pos + (L - S)], np.int64)
        visualcla.check_img_start_pos(img_pos, self.cfg.num_image_tokens, L)
        pixels = host_pixels(pixel_values)
        if pixels is not None and img_pos.ndim == 2 and pixels.dim() == 4:
            pixels = pixels[None]  # (1, K, 3, H, W)
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
        self._host_active[row] = True
        self._host_finished[row] = False
        self._host_gen_len[row] = 1
        self._host_max_len[row] = max_new
        self._host_bucket[row] = L
        self._host_knobs[row] = knobs

    # -- decode ----------------------------------------------------------------

    def _decode_step(self, flags: dict) -> None:
        """One gated decode step over the static buffers, in place: every
        running row writes its token's K/V at its ``cur_slot`` and attends
        (B1 in every layer), then commits the next token.  ``go`` is the JAX
        ``_step_n_impl`` cond (a row runs, none finished since the chunk
        began), ANDed into ``run``; rows that do not run write into their
        ``cur_slot``, which stays invalid."""
        s, text = self._state, self.model.text
        rows, Smax, T = self._rows, self.Smax, self.T
        run = s.active & ~s.finished
        go = (run.any() & ~(s.finished & ~self._finished0).any()
              & self.graphs.enable(self.device))
        run = run & go
        slot = s.cur_slot.clamp(max=Smax - 1)
        s.kv_valid[rows, slot] = s.kv_valid[rows, slot] | run
        hidden, _ = text(text.embed(s.last_token[:, None]), s.positions[:, None], s.cache,
                         s.kv_valid, slot)
        token, new_mu = sample_step_rowwise(
            text.logits(hidden)[:, 0], s.gen_ids, s.gen_len, s.generator, self.sampling,
            **knob_kwargs(s.knobs, s.mu), flags=flags)
        s.mu.copy_(torch.where(run, new_mu, s.mu))
        token = torch.where(run, token, torch.full_like(token, self.pad))
        idx = s.gen_len.clamp(max=T - 1)
        s.gen_ids[rows, idx] = torch.where(run, token, s.gen_ids[rows, idx])
        s.gen_len += run.long()
        hit_eos = run & (token == self.eos)
        hit_cap = run & ((s.gen_len >= s.max_len) | (s.cur_slot + 1 >= Smax))
        s.cur_slot += run.long()
        s.positions += run.long()
        s.last_token.copy_(torch.where(run, token, s.last_token))
        s.finished |= hit_eos | hit_cap
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
        run = self._host_active & ~self._host_finished
        if run.any():
            cur = self._host_bucket + self._host_gen_len - 1
            to_cap = np.minimum(self._host_max_len - self._host_gen_len, self.Smax - cur)
            n = min(n, max(1, int(to_cap[run].min())))
        flags = knob_flags(self._host_knobs[self._host_active])
        self._finished0.copy_(self._state.finished)
        with attention_mesh_scope(self.mesh):
            self.graphs.run(("decode", tuple(sorted(flags.items()))),
                            lambda: self._decode_step(flags), self.device,
                            generators=[self._state.generator], counters=[self.counts],
                            replays=n)

    def step(self) -> None:
        """One decode step for every running row."""
        self.step_n(1)

    def snapshot(self) -> dict:
        """The rows' control fields in one device-to-host copy (and the live
        steps run, for ``decode_steps``)."""
        s = self._state
        packed = torch.cat([s.last_token[:, None], s.gen_len[:, None], s.active[:, None].long(),
                            s.finished[:, None].long(), s.gen_ids], dim=1).reshape(-1)
        packed = torch.cat([packed, self._live]).cpu().numpy()
        live = int(packed[-1])
        self.decode_steps += live - self._live_host
        self.counts["live_decode_passes"] += live - self._live_host
        self._live_host = live
        packed = packed[:-1].reshape(self.B, -1)
        snap = {"last_token": packed[:, 0], "gen_len": packed[:, 1],
                "active": packed[:, 2].astype(bool), "finished": packed[:, 3].astype(bool),
                "gen_ids": packed[:, 4:]}
        self._host_finished = snap["finished"].copy()
        self._host_gen_len = snap["gen_len"].astype(np.int64)
        return snap

    def release_row(self, row: int) -> None:
        self.release_rows([row])

    def release_rows(self, rows) -> None:
        """Free finished rows without a device fetch (the scheduler holds
        their ids from its snapshot): one update for every row retiring."""
        rows = list(rows)
        idx = torch.as_tensor(rows, dtype=torch.int64, device=self.device)
        s = self._state
        s.active[idx] = False
        s.finished[idx] = False
        s.kv_valid[idx] = False
        self._host_active[rows] = False
        self._host_finished[rows] = False

    def collect_row(self, row: int) -> np.ndarray:
        """The generated ids of a finished row, then free it."""
        gen_len = int(self._state.gen_len[row])
        ids = self._state.gen_ids[row, :gen_len].cpu().numpy().copy()
        self.release_row(row)
        return ids

    def num_active(self) -> int:
        return int(self._state.active.sum())


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
        release = getattr(self.engine, "release_followers", None)
        if release is not None:
            release()

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
            release = getattr(self.engine, "release_followers", None)
            if release is not None:
                try:  # the other ranks' follow raises with the message
                    release(msg)
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
        idle = getattr(eng, "idle", None)  # over a mesh: the leader's heartbeat
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
                can_admit = getattr(eng, "can_admit", None)
                if can_admit is not None and not can_admit(len(req.input_ids)):
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
                begin = getattr(eng, "begin_prefill", None)
                wants_chunked = (begin is not None and self.prefill_chunk > 0
                                 and (self._rows or self._pending is not None)
                                 and backlog <= self.chunked_backlog_limit
                                 and len(req.input_ids) > self.prefill_chunk)
                if wants_chunked and self._pending is not None:
                    deferred = req  # one chunked admission at a time
                    break
                t0 = time.time_ns()
                if wants_chunked:
                    try:
                        self._pending = (begin(
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
                    spec_ready = getattr(eng, "spec_ready", None)
                    if (spec_ready is not None and len(self._rows) <= eng.spec_max_active
                            and spec_ready()):
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
                    if idle is not None:
                        idle()
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
