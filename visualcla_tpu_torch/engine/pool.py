"""The row protocol both serving pools share, and the contract the
``server.Scheduler`` reads a pool through.

``RowPool`` owns the B rows' control on the device (``RowState``) and on the
host, whatever a pool keeps of the K/V (``server.ServingEngine`` a stacked
cache, ``paged.PagedServingEngine`` a block pool): the decode step's gate,
the commit of a sampled token, a row's activation at its first token, the
cap on a chunk's replays, ``snapshot`` and the release of rows.  The pools'
differences are data passed in or short overrides.  The Scheduler calls
``prefill_row``, ``step_n``, ``step``, ``snapshot`` and ``release_rows``,
and the members whose defaults below stand for a feature the pool lacks.
A request's knobs (``KNOB_NAMES``) travel as one (11,) f32 row.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models import visualcla
from ..parallel.sharding import bind
from .generate import host_pixels, pick_bucket
from .graphs import Graphs
from .sampling import SamplingConfig, rowwise_flags

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
class RowState:
    """The rows' control on the device, every tensor rows first."""

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


class RowPool:
    """B rows of requests on the device and their host mirrors; a pool
    extends it with its K/V (see the module's docstring)."""

    live_counters = 1  # the live-step counters ``_live`` holds (decode steps first)
    chunked_admission = False  # begin_prefill admits a prompt chunk by chunk
    spec_max_active = 0  # the Scheduler speculates while at most this many rows live

    def __init__(self, model: visualcla.VisualCLAModel, cfg, *, eos_token_id: int,
                 pad_token_id: int, pool_size: int, max_seq_len: int, max_new_tokens_cap: int,
                 sampling: Optional[SamplingConfig], mesh):
        bind(model, mesh)
        self.mesh = mesh  # the K/V holds the rank's kv heads; rows are not split
        self.model = model
        self.cfg = cfg
        self.eos = eos_token_id
        self.pad = pad_token_id
        self.B = pool_size
        self.Smax = max_seq_len
        self.T = max_new_tokens_cap
        self.sampling = _check_serving_sampling(sampling or SamplingConfig())
        p = model.text.final_norm.weight  # a float leaf at every weight tier
        self.device, self.dtype = p.device, p.dtype
        B, dev = self.B, self.device
        # host mirrors: active is host-driven; finished and the generated
        # lengths as of the last snapshot or chunk read back (a row that
        # ends at its admission shows only at the next one)
        self._host_active = np.zeros(B, bool)
        self._host_finished = np.zeros(B, bool)
        self._host_gen_len = np.zeros(B, np.int64)
        self._host_max_len = np.zeros(B, np.int64)
        self._host_knobs = np.tile(sampling_knobs(self.sampling, None), (B, 1))
        # the decode chunk's static inputs: the finished flags at its start,
        # and the live (ungated) steps run so far
        self._finished0 = torch.zeros(B, dtype=torch.bool, device=dev)
        self._live = torch.zeros(self.live_counters, dtype=torch.int64, device=dev)
        self._live_host = np.zeros(self.live_counters, np.int64)
        self._rows = torch.arange(B, device=dev)
        self.decode_steps = 0  # live decode steps run (counts["decode_passes"]: all)
        self.graphs = Graphs()
        # forward passes run on the device, gated ones included; the live
        # (ungated) decode passes as of the last read back
        self.counts = {"decode_passes": 0, "prefill_passes": 0, "live_decode_passes": 0}

    def _row_fields(self, seed: int) -> dict:
        """``RowState``'s fields, zeroed: no row runs."""
        dev, B = self.device, self.B
        z = dict(dtype=torch.int64, device=dev)
        return dict(
            positions=torch.zeros(B, **z), last_token=torch.zeros(B, **z),
            gen_ids=torch.zeros(B, self.T, **z), gen_len=torch.zeros(B, **z),
            max_len=torch.zeros(B, **z), active=torch.zeros(B, dtype=torch.bool, device=dev),
            finished=torch.zeros(B, dtype=torch.bool, device=dev),
            mu=torch.full((B,), 2.0 * self.sampling.mirostat_tau, device=dev),
            knobs=torch.as_tensor(self._host_knobs, device=dev),
            generator=torch.Generator(device=dev).manual_seed(seed))

    # -- admission -------------------------------------------------------------

    def bucket_len(self, n: int) -> int:
        """The bucket a prompt of ``n`` tokens pads to; past the buckets the
        pool's own overflow length, if it holds the prompt within Smax."""
        try:
            return pick_bucket(self.prompt_buckets, n)
        except ValueError:
            L = self._overflow_len(n)
            if n <= L <= self.Smax:
                return L
            raise

    def _host_prompt(self, input_ids, img_start_pos, pixel_values, left: bool):
        """The prompt (S,) padded LEFT or right to its bucket L, its image
        markers (-1: none) shifted with it and checked.
        -> (ids (1, L), mask (1, L), markers, host pixels, S, L)."""
        input_ids = np.asarray(input_ids, np.int64).reshape(-1)
        S = len(input_ids)
        L = self.bucket_len(S)
        at = L - S if left else 0
        ids = np.full((1, L), self.pad, np.int64)
        mask = np.zeros((1, L), np.int64)
        ids[0, at:at + S] = input_ids
        mask[0, at:at + S] = 1
        if img_start_pos is not None and np.ndim(img_start_pos) > 0:
            ip = np.asarray(img_start_pos, np.int64).reshape(1, -1)
            img_pos = np.where(ip < 0, -1, ip + at)
        else:
            img_pos = np.asarray([-1 if img_start_pos is None or img_start_pos < 0
                                  else img_start_pos + at], np.int64)
        visualcla.check_img_start_pos(img_pos, self.cfg.num_image_tokens, L)
        pixels = host_pixels(pixel_values)
        if pixels is not None and img_pos.ndim == 2 and pixels.dim() == 4:
            pixels = pixels[None]  # (1, K, 3, H, W)
        return ids, mask, img_pos, pixels, S, L

    def _activate(self, row, token, mu, knobs, max_new, position, finished) -> None:
        """Set row ``row`` (a (1,) device index) running from its first
        ``token`` (1,); ``finished`` (1,): the admission completes it."""
        s = self._state
        s.positions.index_copy_(0, row, position)
        s.last_token.index_copy_(0, row, token)
        s.gen_ids.index_copy_(0, row, F.pad(token[:, None], (0, self.T - 1)))
        s.gen_len.index_fill_(0, row, 1)
        s.max_len.index_copy_(0, row, max_new)
        s.active.index_fill_(0, row, True)
        s.finished.index_copy_(0, row, finished)
        s.mu.index_copy_(0, row, mu)
        s.knobs.index_copy_(0, row, knobs)

    def _host_activate(self, row: int, max_new: int, knobs: np.ndarray) -> None:
        """The host mirrors of a row an admission set running."""
        self._host_active[row] = True
        self._host_finished[row] = False
        self._host_gen_len[row] = 1
        self._host_max_len[row] = max_new
        self._host_knobs[row] = knobs

    # -- decode ----------------------------------------------------------------

    def _gate(self):
        """(run, go): the running rows and the JAX ``_step_n_impl`` cond (a
        row runs, none finished since the chunk began), ANDed into run."""
        s = self._state
        run = s.active & ~s.finished
        go = (run.any() & ~(s.finished & ~self._finished0).any()
              & self.graphs.enable(self.device))
        return run & go, go

    def _commit(self, run, token, new_mu, lens) -> None:
        """Commit a sampled token (B,) for the rows in ``run``, in place.  A
        row finishes at EOS, at its max_new_tokens, or at ``lens`` + 1 >= Smax."""
        s, rows = self._state, self._rows
        s.mu.copy_(torch.where(run, new_mu, s.mu))
        token = torch.where(run, token, torch.full_like(token, self.pad))
        idx = s.gen_len.clamp(max=self.T - 1)
        s.gen_ids[rows, idx] = torch.where(run, token, s.gen_ids[rows, idx])
        s.gen_len += run.long()
        self._record(run, token)
        hit_eos = run & (token == self.eos)
        hit_cap = run & ((s.gen_len >= s.max_len) | (lens + 1 >= self.Smax))
        s.last_token.copy_(torch.where(run, token, s.last_token))
        s.positions += run.long()
        s.finished |= hit_eos | hit_cap

    def _record(self, run, token) -> None:
        """A pool's own record of each committed token."""

    def _chunk_len(self, n: int, room: np.ndarray) -> int:
        """``n`` cut at the first running row's cap (host mirrors): its
        max_new_tokens, or ``room`` (B,), the steps its cache has left."""
        run = self._host_active & ~self._host_finished
        if run.any():
            to_cap = np.minimum(self._host_max_len - self._host_gen_len, room)
            n = min(n, max(1, int(to_cap[run].min())))
        return n

    def _replay(self, kind: str, n: int, step) -> None:
        """A chunk: ``n`` replays of the gated step ``step(flags)``, captured
        under its kind and the live rows' sampler branch flags."""
        flags = knob_flags(self._host_knobs[self._host_active])
        self._finished0.copy_(self._state.finished)
        self.graphs.run((kind, tuple(sorted(flags.items()))), lambda: step(flags), self.device,
                        generators=[self._state.generator], counters=[self.counts], replays=n)

    def _count_live(self, live: np.ndarray) -> np.ndarray:
        """Publish the live-step counters read back: -> what they moved."""
        moved = live - self._live_host
        self._live_host = live
        self.decode_steps += int(moved[0])
        self.counts["live_decode_passes"] += int(moved[0])
        return moved

    def step(self) -> None:
        """One decode step for every running row."""
        self.step_n(1)

    def _control(self) -> torch.Tensor:
        """(B, 4 + T): last token, generated length, active, finished, ids."""
        s = self._state
        return torch.cat([s.last_token[:, None], s.gen_len[:, None], s.active[:, None].long(),
                          s.finished[:, None].long(), s.gen_ids], dim=1)

    def _read_control(self, packed: np.ndarray) -> dict:
        """The snapshot of a host copy of ``_control``; the mirrors refreshed."""
        snap = {"last_token": packed[:, 0], "gen_len": packed[:, 1],
                "active": packed[:, 2].astype(bool), "finished": packed[:, 3].astype(bool),
                "gen_ids": packed[:, 4:]}
        self._host_finished = snap["finished"].copy()
        self._host_gen_len = snap["gen_len"].astype(np.int64)
        return snap

    def snapshot(self) -> dict:
        """The rows' control fields in one device-to-host copy."""
        return self._read_control(self._control().cpu().numpy())

    # -- release ---------------------------------------------------------------

    def release_row(self, row: int) -> None:
        self.release_rows([row])

    def release_rows(self, rows) -> None:
        """Free finished rows without a device fetch (the scheduler holds
        their ids from its snapshot): one update for every row retiring."""
        rows = list(rows)
        idx = torch.as_tensor(rows, dtype=torch.int64, device=self.device)
        self._state.active[idx] = False
        self._state.finished[idx] = False
        self._host_active[rows] = False
        self._host_finished[rows] = False
        self._release(rows, idx)

    def _release(self, rows: list, idx: torch.Tensor) -> None:
        """A pool's own release of its rows' K/V."""

    def collect_row(self, row: int) -> np.ndarray:
        """The generated ids of a finished row, then free it."""
        gen_len = int(self._state.gen_len[row])
        ids = self._state.gen_ids[row, :gen_len].cpu().numpy().copy()
        self.release_row(row)
        return ids

    def num_active(self) -> int:
        return int(self._state.active.sum())

    # -- the Scheduler's contract: defaults of a pool without the feature ------

    def can_admit(self, prompt_len: int) -> bool:
        """Whether a prompt of this length can be admitted now."""
        return True

    def begin_prefill(self, *args, **kwargs):
        """A chunked admission (``chunked_admission``)."""
        raise NotImplementedError(f"{type(self).__name__} admits a prompt in one shot")

    def spec_ready(self) -> bool:
        """Whether a speculative iteration can gain anything now."""
        return False

    def spec_step_n(self, n: int) -> None:
        raise NotImplementedError(f"{type(self).__name__} does not speculate")

    def idle(self) -> None:
        """Called while the Scheduler's loop has nothing to do."""

    def release_followers(self, error: Optional[str] = None) -> None:
        """Called once the Scheduler's loop stops (``error``: it died)."""
