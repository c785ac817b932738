"""Beam search, ``num_beams > 1`` (port of visualcla_tpu/engine/beam.py, the
host-driven forms).

HF beam search over the composite model, generated-only ids returned:

- device: the prompt's prefill runs once, one row through kernel B2, and its
  cache fans out to the ``nb`` beams; each step is one forward of the nb
  beams' last tokens at B = nb (kernel B1 a layer), a log-softmax and a
  top-2nb over the (nb x V) scores, so only the 2nb candidates go to the
  host; ``_reorder_tail`` then gathers the live window of the cache in place;
- host: HF's ``BeamSearchScorer`` bookkeeping (candidate order, EOS
  hypotheses scored ``sum_logprob / len**length_penalty`` when added,
  worst-hypothesis eviction, the ``is_done`` early-stopping rule).

``beam_sample_generate`` is HF's ``beam_sample`` (``do_sample=True``): the
2nb candidates are drawn without replacement by Gumbel-top-k from an
explicit ``torch.Generator``.  The JAX package's device-resident
``beam_generate_fused`` has no counterpart yet (ROADMAP item 3: the loop
captured in a CUDA graph); ``beam_generate`` is held token-identical to it
there.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models import llama, visualcla
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


class _BeamState:
    """The beams' cache, validity and write slot after the shared prefill."""

    def __init__(self, model, cfg, input_ids, pixel_values, img_start_pos, nb: int,
                 max_new_tokens: int, max_seq_len: Optional[int], cache_slots: Optional[int],
                 kv_quant: str):
        if np.asarray(input_ids).shape[0] != 1:
            raise ValueError(
                f"beam search supports batch size 1, got {np.asarray(input_ids).shape[0]} "
                "(prefill builds a single-row cache that fans out to num_beams)")
        text = model.text
        p = text.final_norm.weight
        dev, dtype = p.device, p.dtype
        S = np.asarray(input_ids).shape[1]
        self.S = S
        self.Smax = max_seq_len or (S + max_new_tokens)  # the decode cap
        alloc = -(-max(self.Smax, cache_slots or 0) // 256) * 256
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
        self.first_logits = text.logits(hidden[:, -1:])[:, 0]  # (1, V) fp32
        # the one prefilled row fans out to the nb beams
        self.cache = {k: v.repeat(1, nb, *([1] * (v.dim() - 2))) for k, v in cache.items()}
        del cache
        self.kv_valid = kv_valid.repeat(nb, 1)
        self.text, self.nb, self.dev = text, nb, dev
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
