"""Sampling (port of visualcla_tpu/engine/sampling.py).

HF's processor/warper order for the reference's default generation config:
min-new-tokens EOS ban -> repetition penalty -> no-repeat-ngram ->
temperature -> top-k -> top-p, then a categorical draw from a
``torch.Generator``.  The penalty and n-gram context is the GENERATED tokens
only (``gen_ids[:, :gen_len]``), as HF sees it when generating from
``inputs_embeds``.  Tail-free, top-a, mirostat and the per-row serving
variants are not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch

NEG_INF = torch.finfo(torch.float32).min


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """The reference's GenerationConfig surface (same fields and defaults as
    ``visualcla_tpu.engine.sampling.SamplingConfig``)."""

    max_new_tokens: int = 512
    min_new_tokens: int = 0
    eos_token_id: int = 2
    num_beams: int = 1
    num_return_sequences: int = 1
    length_penalty: float = 1.0
    early_stopping: bool = False
    do_sample: bool = True
    temperature: float = 0.5
    top_k: int = 40
    top_p: float = 0.9
    repetition_penalty: float = 1.1
    no_repeat_ngram_size: int = 15
    tfs: float = 1.0
    top_a: float = 0.0
    mirostat_mode: int = 0
    mirostat_tau: float = 5.0
    mirostat_eta: float = 0.1

    @classmethod
    def greedy(cls, max_new_tokens: int = 512) -> "SamplingConfig":
        """HF do_sample=False with no penalties and no warpers."""
        return cls(max_new_tokens=max_new_tokens, do_sample=False, temperature=1.0,
                   top_k=0, top_p=1.0, repetition_penalty=1.0, no_repeat_ngram_size=0)


def check_supported(cfg: SamplingConfig) -> None:
    if cfg.tfs < 1.0 or cfg.top_a > 0.0 or cfg.mirostat_mode == 2:
        raise NotImplementedError(
            "tail-free, top-a and mirostat sampling are not ported yet "
            "(ROADMAP, open item 2: remaining samplers)")


def _scatter_or(B: int, V: int, ids: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """(B, V) bool mask, True at ids[b, i] wherever flags[b, i] (an OR over
    duplicates: unflagged entries go to a spare column that is dropped)."""
    mask = torch.zeros(B, V + 1, dtype=torch.bool, device=ids.device)
    idx = torch.where(flags, ids.long(), torch.full_like(ids.long(), V))
    mask.scatter_(1, idx, True)
    return mask[:, :V]


def apply_repetition_penalty(logits, gen_ids, gen_valid, penalty: float):
    """HF RepetitionPenaltyLogitsProcessor over the valid generated ids."""
    B, V = logits.shape
    seen = _scatter_or(B, V, gen_ids, gen_valid)
    penalized = torch.where(logits < 0, logits * penalty, logits / penalty)
    return torch.where(seen, penalized, logits)


def apply_no_repeat_ngram(logits, gen_ids, gen_len, ngram_size: int):
    """HF NoRepeatNGramLogitsProcessor: ban x if [last n-1 tokens, x] already
    occurred in the generated context."""
    if ngram_size <= 0:
        return logits
    B, T = gen_ids.shape
    n = ngram_size
    if T < n:
        return logits
    dev = gen_ids.device
    num_w = T - n + 1
    idx = torch.arange(num_w, device=dev)[:, None] + torch.arange(n - 1, device=dev)[None, :]
    prefixes = gen_ids[:, idx]  # (B, num_w, n-1)
    banned = gen_ids[:, torch.arange(num_w, device=dev) + n - 1]  # (B, num_w)
    start = gen_len[:, None] - (n - 1) + torch.arange(n - 1, device=dev)[None, :]
    cur = torch.gather(gen_ids, 1, start.clamp(0, T - 1))  # (B, n-1)
    match = (prefixes == cur[:, None, :]).all(dim=-1)
    w_ok = (torch.arange(num_w, device=dev)[None, :] + n - 1) < gen_len[:, None]
    have_ctx = gen_len[:, None] >= (n - 1)
    ban = _scatter_or(B, logits.shape[1], banned, match & w_ok & have_ctx)
    return torch.where(ban, torch.full_like(logits, NEG_INF), logits)


def warp_top_k(logits, k: int):
    if k <= 0:
        return logits
    k = min(k, logits.shape[-1])
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)


def warp_top_p(logits, p: float, min_tokens_to_keep: int = 1):
    """HF TopPLogitsWarper: stable ascending sort, drop tokens whose
    cumulative probability from the low end is <= 1 - p, keep the top
    ``min_tokens_to_keep``."""
    if p >= 1.0:
        return logits
    sorted_logits, sorted_idx = torch.sort(logits, dim=-1, stable=True)
    cum = torch.softmax(sorted_logits, dim=-1).cumsum(dim=-1)
    remove_sorted = cum <= (1.0 - p)
    if min_tokens_to_keep > 0:
        remove_sorted[..., -min_tokens_to_keep:] = False
    remove = torch.zeros_like(remove_sorted).scatter(-1, sorted_idx, remove_sorted)
    return torch.where(remove, torch.full_like(logits, NEG_INF), logits)


def processed_logits(logits, gen_ids, gen_len, cfg: SamplingConfig):
    """The context-dependent processors shared by greedy and sampling."""
    logits = logits.float()
    T = gen_ids.shape[1]
    gen_valid = torch.arange(T, device=gen_ids.device)[None, :] < gen_len[:, None]
    if cfg.min_new_tokens > 0:
        ban = (gen_len < cfg.min_new_tokens)[:, None]
        eos_col = torch.arange(logits.shape[-1], device=logits.device)[None, :] == cfg.eos_token_id
        logits = torch.where(ban & eos_col, torch.full_like(logits, NEG_INF), logits)
    if cfg.repetition_penalty != 1.0:
        logits = apply_repetition_penalty(logits, gen_ids, gen_valid, cfg.repetition_penalty)
    if cfg.no_repeat_ngram_size > 0:
        logits = apply_no_repeat_ngram(logits, gen_ids, gen_len, cfg.no_repeat_ngram_size)
    return logits


def warped_logits(logits, gen_ids, gen_len, cfg: SamplingConfig):
    """The full pipeline short of the draw: softmax of the result is the
    sampling distribution."""
    check_supported(cfg)
    logits = processed_logits(logits, gen_ids, gen_len, cfg)
    if cfg.temperature != 1.0:
        logits = logits / cfg.temperature
    if cfg.top_k > 0:
        logits = warp_top_k(logits, cfg.top_k)
    if cfg.top_p < 1.0:
        logits = warp_top_p(logits, cfg.top_p)
    return logits


def sample_step(logits, gen_ids, gen_len, generator: torch.Generator,
                cfg: SamplingConfig) -> torch.Tensor:
    """One step: (B, V) logits -> (B,) int64 tokens."""
    if not cfg.do_sample:
        return processed_logits(logits, gen_ids, gen_len, cfg).argmax(dim=-1)
    probs = torch.softmax(warped_logits(logits, gen_ids, gen_len, cfg), dim=-1)
    # exponential race: argmax(p / E), E ~ Exp(1), draws index i with prob p_i
    race = torch.empty_like(probs).exponential_(generator=generator)
    return (probs / race).argmax(dim=-1)
