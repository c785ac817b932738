"""Beam search, ``num_beams > 1`` (port of visualcla_tpu/engine/beam.py).

HF beam search over the composite model, generated-only ids returned:

- device: the prompt's prefill runs once, one row through kernel B2, and its
  cache fans out to the ``nb`` beams; each step is one forward of the nb
  beams' last tokens at B = nb (kernel B1 a layer), a log-softmax and a
  top-2nb over the (nb x V) scores; ``_reorder_tail`` gathers the live
  window of the cache in place;
- ``beam_generate_fused`` (the JAX package's default greedy path): the
  scorer's state lives in fixed-shape device tensors (hypothesis ids,
  lengths and scores, worst-score eviction, the ``is_done`` rule), and one
  gated step (reorder, forward, top-2nb, candidate routing) is captured in a
  CUDA graph and replayed ``BEAM_CHUNK`` times between host reads of the
  device's stop flag (``engine/graphs.py``); the final pass over the live
  beams runs once after the loop;
- ``beam_generate`` (``VISUALCLA_BEAM=host``, and ``num_return_sequences >
  1``): only the 2nb candidates go to the host, where HF's
  ``BeamSearchScorer`` bookkeeping runs (candidate order, EOS hypotheses
  scored ``sum_logprob / len**length_penalty`` when added, worst-hypothesis
  eviction, the ``is_done`` early-stopping rule).

``beam_sample_generate`` is HF's ``beam_sample`` (``do_sample=True``), host
driven as in the JAX package: the 2nb candidates are drawn without
replacement by Gumbel-top-k from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
import threading
import weakref
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models import llama, visualcla
from .graphs import LOCK, Graphs
from .sampling import apply_no_repeat_ngram, apply_repetition_penalty, warp_top_k, warp_top_p

Cand = List[Tuple[float, int, int]]  # (score, beam, token), best first


@torch.no_grad()
def _reorder_tail(cache: dict, beam_idx: torch.Tensor, prompt_len: int, end: int) -> dict:
    """Beam-reorder only the live generated window of the cache, in place.

    Every beam descends from one shared prefill, so slots ``[0, prompt_len)``
    are equal across the beam axis and slots from ``end`` (the next write
    slot) on are still zeros: gathering the whole ``(L, nb, Nkv, S, hd)``
    buffer (4.3 GB a step at 7B, 4 beams, 2048 slots) would move bytes that
    cannot differ.  The slot axis is 3 for every leaf (k / v and the int8
    cache's (L, B, Nkv, S) scales)."""
    if end > prompt_len:
        for v in cache.values():
            win = v[:, :, :, prompt_len:end]
            win.copy_(win.index_select(1, beam_idx))
    return cache


@dataclasses.dataclass
class _Hyp:
    ids: np.ndarray
    score: float  # length-normalized


class BeamHypotheses:
    """HF BeamHypotheses: keep the best ``num_beams`` finished candidates."""

    def __init__(self, num_beams: int, length_penalty: float, early_stopping: bool):
        self.num_beams = num_beams
        self.length_penalty = length_penalty
        self.early_stopping = early_stopping
        self.hyps: List[_Hyp] = []
        self.worst_score = 1e9

    def add(self, ids: np.ndarray, sum_logprob: float) -> None:
        score = sum_logprob / (len(ids) ** self.length_penalty)
        if len(self.hyps) < self.num_beams or score > self.worst_score:
            self.hyps.append(_Hyp(ids=ids, score=score))
            if len(self.hyps) > self.num_beams:
                worst = min(range(len(self.hyps)), key=lambda i: self.hyps[i].score)
                del self.hyps[worst]
            self.worst_score = min(h.score for h in self.hyps)

    def is_done(self, best_sum_logprob: float, cur_len: int) -> bool:
        if len(self.hyps) < self.num_beams:
            return False
        if self.early_stopping:
            return True
        return self.worst_score >= best_sum_logprob / (cur_len ** self.length_penalty)

    def ranked(self) -> List[_Hyp]:
        return sorted(self.hyps, key=lambda h: -h.score)

    def best(self) -> np.ndarray:
        return max(self.hyps, key=lambda h: h.score).ids

    def best_n(self, n: int) -> List[np.ndarray]:
        """Top-n finished hypotheses, best first (HF finalize with
        num_return_sequences=n)."""
        return [h.ids for h in self.ranked()[:n]]


def _check_one_row(input_ids) -> None:
    if np.asarray(input_ids).shape[0] != 1:
        raise ValueError(
            f"beam search supports batch size 1, got {np.asarray(input_ids).shape[0]} "
            "(prefill builds a single-row cache that fans out to num_beams)")


def _cache_slots(S: int, max_new_tokens: int, max_seq_len: Optional[int],
                 cache_slots: Optional[int]) -> Tuple[int, int]:
    """(the decode cap, the cache's slots: a multiple of 256 at least
    ``cache_slots``)."""
    cap = max_seq_len or (S + max_new_tokens)
    return cap, -(-max(cap, cache_slots or 0) // 256) * 256


@torch.no_grad()
def _prefill_row(model, cfg, input_ids, pixel_values, img_start_pos, alloc: int,
                 kv_quant: str):
    """The shared prompt's prefill, one row into a fresh ``alloc``-slot
    cache: (first logits (1, V) fp32, cache)."""
    text = model.text
    p = text.final_norm.weight
    dev, dtype = p.device, p.dtype
    S = np.asarray(input_ids).shape[1]
    if img_start_pos is None:
        img_pos = np.full((1,), -1, np.int64)
    else:
        img_pos = np.asarray(img_start_pos)
        visualcla.check_img_start_pos(img_pos, cfg.num_image_tokens, S)
    if pixel_values is not None:
        pixel_values = torch.as_tensor(np.asarray(pixel_values)).to(dev, dtype)
    ids = torch.as_tensor(np.asarray(input_ids, np.int64), device=dev)
    embeds = visualcla.multimodal_embeds(model, cfg, ids, img_pos, pixel_values)
    cache = llama.init_kv_cache(cfg.text_config, 1, alloc, dtype, device=dev,
                                kv_quant=kv_quant)
    kv_valid = torch.zeros(1, alloc, dtype=torch.bool, device=dev)
    kv_valid[:, :S] = True
    positions = torch.arange(S, device=dev)[None]
    hidden, cache = text(embeds, positions, cache, kv_valid, 0)
    return text.logits(hidden[:, -1:])[:, 0], cache


class _BeamState:
    """The beams' cache, validity and write slot after the shared prefill."""

    def __init__(self, model, cfg, input_ids, pixel_values, img_start_pos, nb: int,
                 max_new_tokens: int, max_seq_len: Optional[int], cache_slots: Optional[int],
                 kv_quant: str):
        _check_one_row(input_ids)
        text = model.text
        S = np.asarray(input_ids).shape[1]
        self.S = S
        self.Smax, alloc = _cache_slots(S, max_new_tokens, max_seq_len, cache_slots)
        self.first_logits, cache = _prefill_row(model, cfg, input_ids, pixel_values,
                                                img_start_pos, alloc, kv_quant)
        # the one prefilled row fans out to the nb beams
        self.cache = {k: v.repeat(1, nb, *([1] * (v.dim() - 2))) for k, v in cache.items()}
        del cache
        self.dev = text.final_norm.weight.device
        self.kv_valid = torch.zeros(nb, alloc, dtype=torch.bool, device=self.dev)
        self.kv_valid[:, :S] = True
        self.text, self.nb = text, nb
        self.slot = S

    def forward(self, tokens: np.ndarray) -> torch.Tensor:
        """One step of the nb beams at the current slot -> (nb, V) fp32 logits."""
        self.kv_valid[:, self.slot] = True
        t = torch.as_tensor(tokens, device=self.dev)[:, None]
        pos = torch.full((self.nb, 1), self.slot, dtype=torch.int64, device=self.dev)
        hidden, _ = self.text(self.text.embed(t), pos, self.cache, self.kv_valid, self.slot)
        self.slot += 1
        return self.text.logits(hidden)[:, 0]


def _to_host(top_scores: torch.Tensor, top_idx: torch.Tensor, V: int) -> Cand:
    scores, idx = top_scores.cpu().tolist(), top_idx.cpu().tolist()
    return [(s, i // V, i % V) for s, i in zip(scores, idx)]


def _search(state: _BeamState, cand: Cand, step: Callable, *, max_new_tokens: int,
            eos_token_id: int, pad_token_id: int, length_penalty: float,
            early_stopping: bool, num_return_sequences: int, stats: Optional[dict]):
    """The host loop shared by both searches: ``step(tokens, scores, gen,
    cur_len)`` runs one device step and returns the next 2nb candidates."""
    nb = state.nb
    hyp = BeamHypotheses(nb, length_penalty, early_stopping)
    gen = [np.zeros((0,), np.int64) for _ in range(nb)]
    next_beams: Cand = []
    gen_synced = False
    steps = 0
    for step_i in range(max_new_tokens):
        # pick nb continuations, route EOS into hypotheses
        next_beams, gen_synced = [], False
        for score, b, tok in cand:
            if tok == eos_token_id:
                hyp.add(np.append(gen[b], eos_token_id), score)
            else:
                next_beams.append((score, b, tok))
            if len(next_beams) == nb:
                break
        while len(next_beams) < nb:  # degenerate: pad with the worst candidate
            next_beams.append((-1e9, 0, pad_token_id))
        cur_len = step_i + 1
        if hyp.is_done(max(s for s, _, _ in cand), cur_len) or state.slot >= state.Smax:
            break
        scores = np.asarray([s for s, _, _ in next_beams], np.float32)
        beam_idx = np.asarray([b for _, b, _ in next_beams], np.int64)
        tokens = np.asarray([t for _, _, t in next_beams], np.int64)
        gen = [np.append(gen[b], t) for b, t in zip(beam_idx, tokens)]
        gen_synced = True  # gen[j] now matches next_beams[j], its token included
        _reorder_tail(state.cache, torch.as_tensor(beam_idx, device=state.dev), state.S,
                      state.slot)
        if step_i == max_new_tokens - 1:
            break
        cand = step(tokens, scores, gen, cur_len)
        steps += 1
    # finalize: open beams become hypotheses (HF finalize when not done early)
    if len(hyp.hyps) < nb and next_beams:
        order = np.argsort(-np.asarray([s for s, _, _ in next_beams]))
        for j in order:
            s, b, t = next_beams[int(j)]
            # a loop that broke before the gen update continues OLD beam b
            # with token t: pair the score with those ids, not with gen[j]
            ids = gen[int(j)] if gen_synced else np.append(gen[b], t)
            hyp.add(ids, s)
            if len(hyp.hyps) >= nb:
                break
    ranked = hyp.ranked()
    if stats is not None:
        stats.update(steps=steps, scores=[h.score for h in ranked])
    if num_return_sequences > 1:
        return [h.ids for h in ranked[:num_return_sequences]]
    return hyp.best()


@torch.no_grad()
def beam_generate(
    model,
    cfg,
    input_ids: np.ndarray,  # (1, S)
    pixel_values: Optional[np.ndarray],
    img_start_pos: Optional[np.ndarray],
    *,
    num_beams: int,
    max_new_tokens: int,
    eos_token_id: int,
    pad_token_id: int = 0,
    length_penalty: float = 1.0,
    early_stopping: bool = False,
    max_seq_len: Optional[int] = None,
    num_return_sequences: int = 1,
    cache_slots: Optional[int] = None,
    kv_quant: str = "none",
    stats: Optional[dict] = None,
):
    """HF-equivalent beam search over ``model`` (a ``VisualCLAModel``) in its
    own dtype and device.  Returns the best hypothesis' generated-only ids
    (EOS included when it ended one), or with ``num_return_sequences`` n > 1
    a list of the top-n hypotheses, best first.  ``max_seq_len`` caps the
    decode (prompt + generated slots); the cache holds at least
    ``cache_slots`` slots (a multiple of 256).  ``stats``, if given, receives
    the number of device steps and the returned hypotheses' scores."""
    nb = num_beams
    state = _BeamState(model, cfg, input_ids, pixel_values, img_start_pos, nb,
                       max_new_tokens, max_seq_len, cache_slots, kv_quant)
    logprobs0 = F.log_softmax(state.first_logits.float(), -1)[0]
    V = logprobs0.shape[-1]
    # beam 0 starts at 0, the others at -1e9: the first step's 2nb candidates
    # are the shared distribution's top 2nb tokens, all from beam 0
    top = torch.topk(logprobs0, 2 * nb)
    cand = [(s, 0, t) for s, t in zip(top.values.cpu().tolist(), top.indices.cpu().tolist())]

    def step(tokens, scores, gen, cur_len):
        logprobs = F.log_softmax(state.forward(tokens).float(), -1)
        flat = (torch.as_tensor(scores, device=state.dev)[:, None] + logprobs).reshape(-1)
        top = torch.topk(flat, 2 * nb)
        return _to_host(top.values, top.indices, V)

    return _search(state, cand, step, max_new_tokens=max_new_tokens, eos_token_id=eos_token_id,
                   pad_token_id=pad_token_id, length_penalty=length_penalty,
                   early_stopping=early_stopping, num_return_sequences=num_return_sequences,
                   stats=stats)


def sample_candidates(logits: torch.Tensor, beam_scores: torch.Tensor, gen_ids: torch.Tensor,
                      gen_len: torch.Tensor, sampling, gumbel: torch.Tensor):
    """HF ``beam_sample``'s draw, (nb, V) raw logits -> 2nb (scores, flat
    indices) sorted by score: log-softmax, the logits processors, + the beam
    scores, the warpers (after the scores, with ``min_tokens_to_keep=2`` as
    HF sets it for nb > 1), then 2nb draws without replacement over the
    (nb x V) distribution as the top 2nb of its log-probabilities plus the
    (1, nb V) Gumbel noise ``gumbel``."""
    nb = logits.shape[0]
    logprobs = F.log_softmax(logits.float(), -1)
    T = gen_ids.shape[1]
    gen_valid = torch.arange(T, device=logits.device)[None, :] < gen_len[:, None]
    if sampling.repetition_penalty != 1.0:
        logprobs = apply_repetition_penalty(logprobs, gen_ids, gen_valid,
                                            sampling.repetition_penalty)
    if sampling.no_repeat_ngram_size > 0:
        logprobs = apply_no_repeat_ngram(logprobs, gen_ids, gen_len,
                                         sampling.no_repeat_ngram_size)
    scores = logprobs + beam_scores[:, None]
    if sampling.temperature != 1.0:
        scores = scores / sampling.temperature
    if sampling.top_k > 0:
        scores = warp_top_k(scores, max(sampling.top_k, 2))
    if sampling.top_p < 1.0:
        scores = warp_top_p(scores, sampling.top_p, min_tokens_to_keep=2)
    flat = scores.reshape(1, -1)
    noisy = F.log_softmax(flat, -1) + gumbel
    top_idx = torch.topk(noisy, 2 * nb).indices
    top_scores = torch.take_along_dim(flat, top_idx, -1)
    order = torch.sort(-top_scores, dim=-1, stable=True).indices
    return (torch.take_along_dim(top_scores, order, -1)[0],
            torch.take_along_dim(top_idx, order, -1)[0])


def gumbel_noise(generator: torch.Generator, shape: tuple, device) -> torch.Tensor:
    """Standard Gumbel noise, ``-log(Exp(1))``, drawn from ``generator``."""
    return -torch.empty(shape, device=device).exponential_(generator=generator).log()


@torch.no_grad()
def beam_sample_generate(
    model,
    cfg,
    input_ids: np.ndarray,  # (1, S)
    pixel_values: Optional[np.ndarray],
    img_start_pos: Optional[np.ndarray],
    sampling,  # SamplingConfig: num_beams, temperature / top-k / top-p, penalties
    *,
    eos_token_id: int,
    pad_token_id: int = 0,
    generator: Optional[torch.Generator] = None,
    max_seq_len: Optional[int] = None,
    cache_slots: Optional[int] = None,
    kv_quant: str = "none",
    stats: Optional[dict] = None,
):
    """HF ``beam_sample`` (``num_beams > 1`` and ``do_sample=True``): the
    2nb candidates of each step are sampled (``sample_candidates``), then
    the bookkeeping is beam search's.  The Gumbel noise comes from
    ``generator`` (a ``torch.Generator`` on the model's device; seed 0 when
    none is given)."""
    nb = sampling.num_beams
    T = sampling.max_new_tokens
    state = _BeamState(model, cfg, input_ids, pixel_values, img_start_pos, nb, T,
                       max_seq_len, cache_slots, kv_quant)
    dev = state.dev
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    V = state.first_logits.shape[-1]

    def gumbel():
        return gumbel_noise(generator, (1, nb * V), dev)

    beam_scores = torch.full((nb,), -1e9, device=dev)
    beam_scores[0] = 0.0
    zeros = torch.zeros(nb, dtype=torch.int64, device=dev)
    ts, ti = sample_candidates(state.first_logits.expand(nb, -1), beam_scores,
                               torch.zeros(nb, T, dtype=torch.int64, device=dev), zeros,
                               sampling, gumbel())
    cand = _to_host(ts, ti, V)

    def step(tokens, scores, gen, cur_len):
        logits = state.forward(tokens)
        gen_buf = np.zeros((nb, T), np.int64)
        for j, g in enumerate(gen):
            gen_buf[j, :len(g)] = g
        ts, ti = sample_candidates(logits, torch.as_tensor(scores, device=dev),
                                   torch.as_tensor(gen_buf, device=dev),
                                   torch.full((nb,), cur_len, dtype=torch.int64, device=dev),
                                   sampling, gumbel())
        return _to_host(ts, ti, V)

    return _search(state, cand, step, max_new_tokens=T, eos_token_id=eos_token_id,
                   pad_token_id=pad_token_id, length_penalty=sampling.length_penalty,
                   early_stopping=sampling.early_stopping,
                   num_return_sequences=getattr(sampling, "num_return_sequences", 1),
                   stats=stats)


# ---------------------------------------------------------------------------
# the device-resident beam search (captured CUDA graphs)
# ---------------------------------------------------------------------------

BEAM_CHUNK = 8  # beam steps (replays of the captured one) between host reads
NEG = -1e9
# model -> {(nb, cache slots, T, kv_quant): _FusedBeam}: one workspace a model
# (its cache is nb x the single-stream one: 4.3 GB at 7B, 4 beams, 2048 slots),
# looked up under _FUSED_LOCK; a search holds its workspace's lock throughout,
# so two searches on one model run one after the other
_FUSED: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_FUSED_LOCK = threading.Lock()


class _FusedBeam:
    """The fused beam search's persistent device state for one (nb, cache
    slots, T) and its graphs: the nb-row cache and validity, the beams'
    tokens, scores, reorder indices and generated ids, the write slot,
    position and step, the stop flag, the hypothesis buffers (ids, lengths,
    scores, count) and the last step's continuations (for the final pass)."""

    def __init__(self, model, cfg, nb: int, alloc: int, T: int, kv_quant: str):
        p = model.text.final_norm.weight
        dev = self.dev = p.device
        # the text tower, not the model: the store's key must stay collectable
        self.text, self.nb, self.T = model.text, nb, T
        self.kv_quant = kv_quant
        self.cache = llama.init_kv_cache(cfg.text_config, nb, alloc, p.dtype, device=dev,
                                         kv_quant=kv_quant)
        self.kv_valid = torch.zeros(nb, alloc, dtype=torch.bool, device=dev)
        i64 = dict(dtype=torch.int64, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        self.gen, self.hyp_ids, self.last_gen = (torch.zeros(nb, T, **i64) for _ in range(3))
        self.beams, self.tokens, self.hyp_len = (torch.zeros(nb, **i64) for _ in range(3))
        self.scores, self.hyp_score, self.last_s = (torch.zeros(nb, **f32) for _ in range(3))
        (self.slot, self.pos, self.i, self.count, self.last_len, self.S,
         self.cap) = (torch.zeros((), **i64) for _ in range(7))
        self.stop = torch.zeros((), dtype=torch.bool, device=dev)
        self.live = torch.zeros((), **i64)  # steps run ungated
        self.ar = torch.arange(nb, device=dev)
        self.window = torch.arange(T, device=dev)
        self.graphs = Graphs()
        self.counts = {"beam_passes": 0}  # forwards run, gated ones included
        self.lock = threading.Lock()  # held by a search

    # -- the scorer on the device (the JAX fused loop's helpers) -------------

    def hyp_add(self, hyp, ids_row, length, sum_logprob, enabled):
        """HF BeamHypotheses.add over fixed buffers: insert while count < nb,
        else evict the worst when the new score beats it."""
        hyp_ids, hyp_len, hyp_score, count = hyp
        nb = self.nb
        score = sum_logprob / length.float() ** self.lp
        filled = torch.where(self.ar < count, hyp_score, torch.full_like(hyp_score, float("inf")))
        can = enabled & ((count < nb) | (score > filled.min()))
        write = torch.where(count < nb, count, filled.argmin())
        sel = (self.ar == write) & can
        return (torch.where(sel[:, None], ids_row[None, :], hyp_ids),
                torch.where(sel, length, hyp_len), torch.where(sel, score, hyp_score),
                count + (can & (count < nb)).long())

    def hyp_worst(self, hyp):
        _, _, hyp_score, count = hyp
        return torch.where(self.ar < count, hyp_score,
                           torch.full_like(hyp_score, float("inf"))).min()

    def is_done(self, hyp, best_cand, cur_len):
        full = hyp[3] >= self.nb
        if self.early_stopping:
            return full
        return full & (self.hyp_worst(hyp) >= best_cand / cur_len.float() ** self.lp)

    def process_candidates(self, cand_s, cand_b, cand_t, gen, i, hyp):
        """Route the 2nb candidates in order: EOS ones into the hypotheses
        (sequentially: eviction depends on order), the first nb others to
        the next beams.  The JAX loop's slow path, which equals its fast
        one when no candidate is EOS, runs on every step."""
        nb, T = self.nb, self.T
        is_eos = cand_t == self.eos
        non = (~is_eos).long()
        before = non.cumsum(0) - non  # non-EOS candidates ahead of each
        active = before < nb  # the host loop breaks once nb are taken
        slot = torch.where(active & ~is_eos, before, torch.full_like(before, nb))
        next_s = torch.full((nb + 1,), NEG, device=self.dev).scatter(0, slot, cand_s)[:nb]
        next_b = torch.zeros(nb + 1, dtype=torch.int64, device=self.dev).scatter(
            0, slot, cand_b)[:nb]
        next_t = torch.full((nb + 1,), self.pad, dtype=torch.int64, device=self.dev).scatter(
            0, slot, cand_t)[:nb]
        at_i = self.window == i
        eos_rows = torch.where(at_i[None, :], self.eos, gen.index_select(0, cand_b))
        for c in range(2 * nb):
            hyp = self.hyp_add(hyp, eos_rows[c], i + 1, cand_s[c], active[c] & is_eos[c])
        return next_s, next_b, next_t, hyp

    def advance(self, cand_s, cand_b, cand_t, go, written: int = 1):
        """Candidate processing at step ``i`` and the state update, where
        ``go``; ``written`` cache slots past ``slot`` count against the cap
        (0 for the prefill's candidates, whose step writes none)."""
        hyp = (self.hyp_ids, self.hyp_len, self.hyp_score, self.count)
        next_s, next_b, next_t, hyp = self.process_candidates(
            cand_s, cand_b, cand_t, self.gen, self.i, hyp)
        next_gen = torch.where((self.window == self.i)[None, :], next_t[:, None],
                               self.gen.index_select(0, next_b))
        stop = (self.is_done(hyp, cand_s.max(), self.i + 1)
                | (self.slot + written >= self.cap) | (self.i + 1 >= self.T))
        for buf, new in ((self.gen, next_gen), (self.scores, next_s), (self.beams, next_b),
                         (self.tokens, next_t), (self.hyp_ids, hyp[0]),
                         (self.hyp_len, hyp[1]), (self.hyp_score, hyp[2]),
                         (self.count, hyp[3]), (self.last_s, next_s),
                         (self.last_gen, next_gen), (self.last_len, self.i + 1)):
            buf.copy_(torch.where(go, new, buf))
        self.stop |= go & stop
        self.i += go.long()

    def step(self) -> None:
        """One gated beam step over device tensors only: reorder the live
        window by the last step's beams (the identity when gated), forward
        the nb beams' tokens (B1 a layer), log-softmax, top-2nb, process."""
        go = ~self.stop & self.graphs.enable(self.dev)
        nb = self.nb
        beams = torch.where(go, self.beams, self.ar)
        Smax = self.kv_valid.shape[1]
        win = (self.S + self.window).clamp(max=Smax - 1)
        for v in self.cache.values():
            v.index_copy_(3, win, v.index_select(3, win).index_select(1, beams))
        slot = self.slot.clamp(max=Smax - 1).expand(nb)
        # (a 0-d index would be read back to the host: index by (nb,) rows)
        self.kv_valid.index_put_((self.ar, slot),
                                 self.kv_valid.gather(1, slot[:, None])[:, 0] | go)
        text = self.text
        hidden, _ = text(text.embed(self.tokens[:, None]), self.pos.expand(nb)[:, None],
                         self.cache, self.kv_valid, slot)
        logprobs = F.log_softmax(text.logits(hidden)[:, 0].float(), -1)
        V = logprobs.shape[-1]
        cand_s, top_i = torch.topk((self.scores[:, None] + logprobs).reshape(-1), 2 * nb)
        self.advance(cand_s, top_i // V, top_i % V, go)
        adv = go.long()
        self.slot += adv
        self.pos += adv
        self.live += adv
        self.counts["beam_passes"] += 1

    @torch.no_grad()
    def search(self, model, cfg, input_ids, pixel_values, img_start_pos, *, alloc: int, cap: int,
               eos: int, pad: int, length_penalty: float, early_stopping: bool,
               stats: Optional[dict]) -> np.ndarray:
        self.eos, self.pad = eos, pad
        self.lp, self.early_stopping = float(length_penalty), bool(early_stopping)
        nb, dev = self.nb, self.dev
        S = np.asarray(input_ids).shape[1]
        with LOCK:
            first_logits, row = _prefill_row(model, cfg, input_ids, pixel_values,
                                             img_start_pos, alloc, self.kv_quant)
        for name, v in row.items():  # the one prefilled row fans out to the nb beams
            self.cache[name].copy_(v.expand_as(self.cache[name]))
        del row
        self.kv_valid.zero_()
        self.kv_valid[:, :S] = True
        for buf in (self.gen, self.hyp_ids, self.hyp_len, self.count, self.live):
            buf.zero_()
        self.hyp_score.fill_(NEG)
        self.S.fill_(S)
        self.cap.fill_(cap)
        self.slot.fill_(S)
        self.pos.fill_(S)
        self.i.zero_()
        self.stop.zero_()
        # step 0: the prefill's candidates, all from beam 0
        beam_scores = torch.full((nb,), NEG, device=dev)
        beam_scores[0] = 0.0
        logprobs0 = F.log_softmax(first_logits.float(), -1)
        V = logprobs0.shape[-1]
        cand_s, top_i = torch.topk((beam_scores[:, None] + logprobs0).reshape(-1), 2 * nb)
        self.advance(cand_s, top_i // V, top_i % V, torch.ones((), dtype=torch.bool, device=dev),
                     written=0)
        key = (self.lp, self.early_stopping, eos, pad)
        while not bool(self.stop):
            self.graphs.run(key, self.step, dev, counters=[self.counts], replays=BEAM_CHUNK)
        # the final pass: open beams become hypotheses in score order while room
        hyp = (self.hyp_ids, self.hyp_len, self.hyp_score, self.count)
        order = torch.argsort(-self.last_s, stable=True)
        for j in range(nb):
            k = order[j]
            hyp = self.hyp_add(hyp, self.last_gen[k], self.last_len, self.last_s[k],
                               hyp[3] < nb)
        hyp_ids, hyp_len, hyp_score, count = hyp
        best = torch.where(self.ar < count, hyp_score,
                           torch.full_like(hyp_score, -float("inf"))).argmax()
        out = torch.cat([hyp_len[best][None], self.live[None], hyp_ids[best]]).cpu().numpy()
        if stats is not None:
            stats.update(steps=int(out[1]), passes=self.counts["beam_passes"],
                         **self.graphs.stats())
        return out[2:2 + int(out[0])]


def beam_generate_fused(
    model,
    cfg,
    input_ids: np.ndarray,  # (1, S)
    pixel_values: Optional[np.ndarray],
    img_start_pos: Optional[np.ndarray],
    *,
    num_beams: int,
    max_new_tokens: int,
    eos_token_id: int,
    pad_token_id: int = 0,
    length_penalty: float = 1.0,
    early_stopping: bool = False,
    max_seq_len: Optional[int] = None,
    cache_slots: Optional[int] = None,
    kv_quant: str = "none",
    stats: Optional[dict] = None,
) -> np.ndarray:
    """Device-resident beam search (the JAX package's ``beam_generate_fused``):
    ``beam_generate``'s best hypothesis with the scorer on the device and
    the step replayed from a captured graph (eagerly on CPU tensors or in
    ``graphs.eager()``), one host read every ``BEAM_CHUNK`` steps.
    The workspace (its nb-row cache, its graphs) is kept for the next call
    of the same (nb, cache slots, max_new_tokens) on ``model``, one a model.
    ``stats``, if given, receives the steps run, the forwards run (gated
    ones included) and the graphs' capture counts."""
    _check_one_row(input_ids)
    nb, T = num_beams, max_new_tokens
    S = np.asarray(input_ids).shape[1]
    cap, alloc = _cache_slots(S, T, max_seq_len, cache_slots)
    key = (nb, alloc, T, kv_quant)
    with _FUSED_LOCK:
        store = _FUSED.setdefault(model, {})
        if key not in store:
            store.clear()  # one workspace a model
            store[key] = _FusedBeam(model, cfg, nb, alloc, T, kv_quant)
        fused = store[key]
    with fused.lock:
        return fused.search(model, cfg, input_ids, pixel_values, img_start_pos, alloc=alloc,
                            cap=cap, eos=eos_token_id, pad=pad_token_id,
                            length_penalty=length_penalty, early_stopping=early_stopping,
                            stats=stats)
