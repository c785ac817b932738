"""Sampling (port of visualcla_tpu/engine/sampling.py).

HF's processor/warper order for the reference's generation config:
min-new-tokens EOS ban -> repetition penalty -> no-repeat-ngram ->
temperature -> top-k -> top-p -> tail-free -> top-a, then a categorical draw
from a ``torch.Generator``; or mirostat-2, which keeps temperature only and
carries a per-row ``mu`` state.  The penalty and n-gram context is the
GENERATED tokens only (``gen_ids[:, :gen_len]``), as HF sees it when
generating from ``inputs_embeds``.

``sample_step_rowwise`` is the serving pool's sampler: every knob is a (B,)
tensor, one value per row.  The JAX package skips its costly branches with
``lax.cond(jnp.any(...))``; here the caller passes ``flags``, which branches
any running row needs, computed on the host from its own copy of the knobs,
so a step never waits on the device to decide a branch.  Skipping a branch
that no row needs leaves every row's tokens as they are.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional, Tuple

import numpy as np
import torch

NEG_INF = torch.finfo(torch.float32).min
TOP_K_CAP = 256  # warp_top_k_rowwise's partial top-k


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


_ROWS = threading.local()


@contextlib.contextmanager
def global_rows(total: int, start: int):
    """Within the block (on this thread), the rows a sampler sees are rows
    ``start ..`` of a ``total``-row batch (a data rank's slice under DP):
    each draw is made for the whole batch and the slice taken, so a split
    run draws what the unsplit run draws for its rows."""
    stack = getattr(_ROWS, "stack", None)
    if stack is None:
        stack = _ROWS.stack = []
    stack.append((total, start))
    try:
        yield
    finally:
        stack.pop()


def current_rows() -> Optional[Tuple[int, int]]:
    """The innermost ``global_rows`` window (total, start) of this thread, or
    None: ``row_noise`` reads it while a graph is captured, so it is part of
    every captured program's key that samples."""
    stack = getattr(_ROWS, "stack", None)
    return stack[-1] if stack else None


def row_noise(like: torch.Tensor, fill) -> torch.Tensor:
    """``fill(t)`` of a new tensor ``t`` shaped like ``like`` (rows first),
    drawn for the whole batch under ``global_rows`` and sliced to ours."""
    window = current_rows()
    if window is None:
        return fill(torch.empty_like(like))
    total, start = window
    full = fill(torch.empty((total,) + tuple(like.shape[1:]), dtype=like.dtype,
                            device=like.device))
    return full[start:start + like.shape[0]]


def draw(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """A categorical draw per row from softmax(logits): the exponential race
    argmax(p / E), E ~ Exp(1), picks index i with probability p_i."""
    probs = torch.softmax(logits, dim=-1)
    race = row_noise(probs, lambda t: t.exponential_(generator=generator))
    return (probs / race).argmax(dim=-1)


def _scatter_or(B: int, V: int, ids: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """(B, V) bool mask, True at ids[b, i] wherever flags[b, i] (an OR over
    duplicates: unflagged entries go to a spare column that is dropped)."""
    mask = torch.zeros(B, V + 1, dtype=torch.bool, device=ids.device)
    idx = torch.where(flags, ids.long(), torch.full_like(ids.long(), V))
    mask.scatter_(1, idx, True)
    return mask[:, :V]


def _unsort(mask_sorted: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """A mask over sorted positions back in vocab order."""
    return torch.zeros_like(mask_sorted).scatter(-1, order, mask_sorted)


# ---------------------------------------------------------------------------
# processors (context-dependent)
# ---------------------------------------------------------------------------

def apply_repetition_penalty(logits, gen_ids, gen_valid, penalty: float):
    """HF RepetitionPenaltyLogitsProcessor over the valid generated ids."""
    B, V = logits.shape
    seen = _scatter_or(B, V, gen_ids, gen_valid)
    penalized = torch.where(logits < 0, logits * penalty, logits / penalty)
    return torch.where(seen, penalized, logits)


def apply_repetition_penalty_rowwise(logits, gen_ids, gen_valid, penalty: torch.Tensor):
    """Per-row penalty, (B,) fp32; rows with 1.0 pass through."""
    B, V = logits.shape
    seen = _scatter_or(B, V, gen_ids, gen_valid)
    p = penalty[:, None]
    penalized = torch.where(logits < 0, logits * p, logits / p)
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


def apply_no_repeat_ngram_rowwise(logits, gen_ids, gen_len, n: torch.Tensor):
    """Per-row n-gram ban, ``n`` (B,) int; rows with n <= 0 pass through and
    n == 1 bans every generated token (HF: the empty prefix matches every
    window).  Each row's prefix of n-1 tokens is masked into one fixed
    (B, T, T) comparison."""
    B, T = gen_ids.shape
    dev = gen_ids.device
    ar = torch.arange(T, device=dev)
    nm1 = (n.long() - 1).clamp(0, T)  # (B,) prefix length
    # the current prefix: the last n-1 generated tokens, right-aligned
    start = gen_len.long()[:, None] - nm1[:, None] + ar[None, :]
    cur = torch.gather(gen_ids, 1, start.clamp(0, T - 1))  # (B, T)
    # window w's prefix position j is gen_ids[w + j]; only j < n-1 counts
    wj = (ar[:, None] + ar[None, :]).clamp(0, T - 1)  # (T_w, T_j)
    pref = gen_ids[:, wj]  # (B, T, T)
    jmask = ar[None, None, :] < nm1[:, None, None]
    match = ((pref == cur[:, None, :]) | ~jmask).all(dim=-1)  # (B, T)
    # the banned token is gen_ids[w + n - 1]: strictly in the past, and the
    # row has n-1 tokens of context
    bpos = ar[None, :] + nm1[:, None]  # (B, T)
    banned = torch.gather(gen_ids, 1, bpos.clamp(0, T - 1))
    gl = gen_len.long()[:, None]
    match = match & (bpos < gl) & (gl >= nm1[:, None]) & (n > 0)[:, None]
    ban = _scatter_or(B, logits.shape[1], banned, match)
    return torch.where(ban, torch.full_like(logits, NEG_INF), logits)


# ---------------------------------------------------------------------------
# warpers (distribution shaping)
# ---------------------------------------------------------------------------

def warp_top_k(logits, k: int):
    if k <= 0:
        return logits
    k = min(k, logits.shape[-1])
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)


def _top_p(logits, threshold, min_tokens_to_keep: int):
    sorted_logits, order = torch.sort(logits, dim=-1, stable=True)
    cum = torch.softmax(sorted_logits, dim=-1).cumsum(dim=-1)
    remove_sorted = cum <= threshold
    if min_tokens_to_keep > 0:
        remove_sorted[..., -min_tokens_to_keep:] = False
    remove = _unsort(remove_sorted, order)
    return torch.where(remove, torch.full_like(logits, NEG_INF), logits)


def warp_top_p(logits, p: float, min_tokens_to_keep: int = 1):
    """HF TopPLogitsWarper: stable ascending sort, drop tokens whose
    cumulative probability from the low end is <= 1 - p, keep the top
    ``min_tokens_to_keep``."""
    if p >= 1.0:
        return logits
    return _top_p(logits, 1.0 - p, min_tokens_to_keep)


def _tfs_remove(logits, tfs: torch.Tensor, min_tokens_to_keep: int):
    B, V = logits.shape
    sorted_logits, order = torch.sort(logits, dim=-1, descending=True, stable=True)
    probs = torch.softmax(sorted_logits, dim=-1)
    d2 = (probs.diff(dim=-1).diff(dim=-1)).abs()  # (B, V-2)
    norm_d2 = d2 / d2.sum(dim=-1, keepdim=True)
    cdf = norm_d2.cumsum(dim=-1)
    remove_sorted = torch.cat([torch.zeros(B, 1, dtype=torch.bool, device=logits.device),
                               cdf > tfs[:, None],
                               torch.ones(B, 1, dtype=torch.bool, device=logits.device)], -1)
    if min_tokens_to_keep > 1:
        remove_sorted[:, :min_tokens_to_keep] = False
    return _unsort(remove_sorted, order)


def warp_tfs(logits, tfs: float, min_tokens_to_keep: int = 1):
    """Tail-free sampling as the reference's TailFreeLogitsWarper, with its
    boundary handling (the last sorted token is always removed)."""
    if tfs >= 1.0:
        return logits
    remove = _tfs_remove(logits, torch.full(logits.shape[:1], tfs, device=logits.device),
                         min_tokens_to_keep)
    return torch.where(remove, torch.full_like(logits, NEG_INF), logits)


def warp_top_a(logits, top_a: float):
    """Top-A: remove tokens with prob < max_prob^2 * top_a."""
    if top_a <= 0.0:
        return logits
    return warp_top_a_rowwise(logits, torch.full(logits.shape[:1], top_a,
                                                 device=logits.device))


def warp_temperature_rowwise(logits, t: torch.Tensor):
    """t (B,) fp32; t = 1 rows pass through."""
    return logits / t.clamp(min=1e-6)[:, None]


def warp_top_p_rowwise(logits, p: torch.Tensor, min_tokens_to_keep: int = 1):
    """p (B,); p = 1 rows keep every token of nonzero probability."""
    return _top_p(logits, (1.0 - p)[:, None], min_tokens_to_keep)


def warp_tfs_rowwise(logits, tfs: torch.Tensor, min_tokens_to_keep: int = 1):
    """Per-row tail-free sampling; rows with tfs >= 1 pass through."""
    remove = _tfs_remove(logits, tfs, min_tokens_to_keep) & (tfs < 1.0)[:, None]
    return torch.where(remove, torch.full_like(logits, NEG_INF), logits)


def warp_top_k_rowwise(logits, k: torch.Tensor, k_cap: int = TOP_K_CAP,
                       full: Optional[bool] = None):
    """Per-row top-k, ``k`` (B,) int; rows with k <= 0 pass through.  One
    partial top-``k_cap`` serves every row with k <= k_cap; a larger k takes
    a full descending sort.  ``full`` says from host knobs whether some row
    that matters needs the sort (both paths give a row with k <= k_cap the
    same threshold); ``None`` reads it from ``k`` on the device."""
    V = logits.shape[-1]
    cap = min(k_cap, V)
    k = k.long()
    if full is None:
        full = not bool((k <= cap).all())
    if not full:
        top = torch.topk(logits, cap, dim=-1).values
        kth = torch.gather(top, 1, (k.clamp(1, cap) - 1)[:, None])
    else:
        desc = torch.sort(logits, dim=-1, descending=True).values
        kth = torch.gather(desc, 1, (k.clamp(1, V) - 1)[:, None])
    out = torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)
    return torch.where((k > 0)[:, None], out, logits)


def warp_top_a_rowwise(logits, top_a: torch.Tensor):
    """Per-row top-A; rows with top_a <= 0 pass through."""
    probs = torch.softmax(logits, dim=-1)
    pmax = probs.amax(dim=-1, keepdim=True)
    remove = probs < pmax * pmax * top_a[:, None]
    return torch.where(remove, torch.full_like(logits, NEG_INF), logits)


# ---------------------------------------------------------------------------
# mirostat-2 (stateful)
# ---------------------------------------------------------------------------

def mirostat_truncate(logits, mu) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort descending and drop the tokens whose surprise (-log2 p) exceeds
    mu, keeping the top token: -> (order (B, V), truncated sorted logits)."""
    sorted_logits, order = torch.sort(logits, dim=-1, descending=True, stable=True)
    probs = torch.softmax(sorted_logits, dim=-1)
    surprise = -torch.log2(probs.clamp(min=1e-30))
    keep = surprise <= mu[:, None]
    keep[:, 0] = True
    return order, torch.where(keep, sorted_logits, torch.full_like(sorted_logits, NEG_INF))


def mirostat_mu(trunc, pick, mu, tau, eta):
    """mu - eta * (surprise of the picked sorted index - tau)."""
    p_pick = torch.gather(torch.softmax(trunc, dim=-1), 1, pick[:, None])[:, 0]
    observed = -torch.log2(p_pick.clamp(min=1e-30))
    return mu - eta * (observed - tau)


def mirostat_step(logits, mu, generator: torch.Generator, tau, eta):
    """Mirostat v2 (the reference's MirostatLogitsWarper): truncate,
    renormalize, draw, update mu.  ``logits`` are temperature-warped;
    tau/eta are floats or (B,) tensors.  -> (token (B,), new_mu (B,))."""
    order, trunc = mirostat_truncate(logits, mu)
    pick = draw(trunc, generator)
    token = torch.gather(order, 1, pick[:, None])[:, 0]
    return token, mirostat_mu(trunc, pick, mu, tau, eta)


# ---------------------------------------------------------------------------
# engine-wide sampler
# ---------------------------------------------------------------------------

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
    sampling distribution (not for mirostat, whose truncation is stateful)."""
    logits = processed_logits(logits, gen_ids, gen_len, cfg)
    if cfg.temperature != 1.0:
        logits = logits / cfg.temperature
    logits = warp_top_k(logits, cfg.top_k)
    logits = warp_top_p(logits, cfg.top_p)
    logits = warp_tfs(logits, cfg.tfs)
    return warp_top_a(logits, cfg.top_a)


def sample_step(logits, gen_ids, gen_len, generator: torch.Generator, mu,
                cfg: SamplingConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step: (B, V) logits -> ((B,) int64 tokens, new mirostat mu (B,))."""
    if not cfg.do_sample:
        return processed_logits(logits, gen_ids, gen_len, cfg).argmax(dim=-1), mu
    if cfg.mirostat_mode == 2:
        logits = processed_logits(logits, gen_ids, gen_len, cfg)
        if cfg.temperature != 1.0:
            logits = logits / cfg.temperature
        return mirostat_step(logits, mu, generator, cfg.mirostat_tau, cfg.mirostat_eta)
    return draw(warped_logits(logits, gen_ids, gen_len, cfg), generator), mu


# ---------------------------------------------------------------------------
# per-row sampler (serving: every pool row carries its own knobs)
# ---------------------------------------------------------------------------

def rowwise_flags(*, temperature=None, top_p, repetition_penalty, do_sample, tfs=None,
                  top_a=None, mirostat=None, top_k=None, ngram=None, **_) -> dict:
    """Which branches any row needs, from host (numpy) or device knobs of the
    rows that matter (a device tensor costs one wait on the device, so a
    captured step is given host knobs only)."""
    a = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
         for k, v in dict(top_p=top_p, rep=repetition_penalty, sample=do_sample, tfs=tfs,
                          top_a=top_a, miro=mirostat, top_k=top_k, ngram=ngram).items()
         if v is not None}
    sample = bool(a["sample"].astype(bool).any())
    miro = "miro" in a and bool((a["miro"].astype(bool) & a["sample"].astype(bool)).any())
    return {"rep": bool((a["rep"] != 1.0).any()),
            "ngram": "ngram" in a and bool((a["ngram"] > 0).any()),
            "sample": sample,
            "top_k": "top_k" in a and bool((a["top_k"] > 0).any()),
            "top_k_full": "top_k" in a and bool((a["top_k"] > TOP_K_CAP).any()),
            "top_p": bool((a["top_p"] < 1.0).any()),
            "tfs": "tfs" in a and bool((a["tfs"] < 1.0).any()),
            "top_a": "top_a" in a and bool((a["top_a"] > 0.0).any()),
            "miro": miro}


def sample_step_rowwise(
    logits, gen_ids, gen_len, generator: torch.Generator, cfg: SamplingConfig, *,
    temperature, top_p, repetition_penalty, do_sample,
    tfs=None, top_a=None, mirostat=None, miro_tau=None, miro_eta=None, mu=None,
    top_k=None, ngram=None, flags: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Serving sampler over per-row (B,) knobs: temperature, top-p,
    repetition penalty, do_sample, tail-free, top-a, mirostat-2 (per-row
    ``mu``), top-k and no-repeat-ngram (``None``: the engine-wide ``cfg``
    value).  ``flags`` (see ``rowwise_flags``) names the branches any row
    needs; ``None`` computes them from the knobs.  Greedy rows take the
    argmax of the processed logits.  -> (token (B,) int64, new_mu (B,))."""
    logits = logits.float()
    B, T = gen_ids.shape
    if mu is None:
        mu = torch.full((B,), 2.0 * cfg.mirostat_tau, device=logits.device)
    if flags is None:
        flags = rowwise_flags(top_p=top_p, repetition_penalty=repetition_penalty,
                              do_sample=do_sample, tfs=tfs, top_a=top_a,
                              mirostat=mirostat, top_k=top_k, ngram=ngram)
    if flags["rep"]:
        gen_valid = torch.arange(T, device=gen_ids.device)[None, :] < gen_len[:, None]
        logits = apply_repetition_penalty_rowwise(logits, gen_ids, gen_valid,
                                                  repetition_penalty)
    if ngram is not None:
        if flags["ngram"]:
            logits = apply_no_repeat_ngram_rowwise(logits, gen_ids, gen_len, ngram)
    elif cfg.no_repeat_ngram_size > 0:
        logits = apply_no_repeat_ngram(logits, gen_ids, gen_len, cfg.no_repeat_ngram_size)
    token = logits.argmax(dim=-1)
    if flags["sample"]:
        warped = warp_temperature_rowwise(logits, temperature)
        if top_k is not None:
            if flags["top_k"]:
                warped = warp_top_k_rowwise(warped, top_k, full=flags.get("top_k_full"))
        else:
            warped = warp_top_k(warped, cfg.top_k)
        if flags["top_p"]:
            warped = warp_top_p_rowwise(warped, top_p)
        if tfs is not None and flags["tfs"]:
            warped = warp_tfs_rowwise(warped, tfs)
        if top_a is not None and flags["top_a"]:
            warped = warp_top_a_rowwise(warped, top_a)
        token = torch.where(do_sample, draw(warped, generator), token)
    if mirostat is None or not flags["miro"]:
        return token, mu
    miro_rows = mirostat & do_sample
    # mirostat keeps temperature and replaces every other warper
    tok_m, mu2 = mirostat_step(warp_temperature_rowwise(logits, temperature), mu,
                               generator, miro_tau, miro_eta)
    return torch.where(miro_rows, tok_m, token), torch.where(miro_rows, mu2, mu)
