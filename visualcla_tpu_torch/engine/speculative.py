"""Prompt-lookup speculative decoding (port of visualcla_tpu/engine/speculative.py).

Each verify chunk drafts K tokens per row from its own context (the K tokens
that followed the most recent earlier occurrence of its last n-gram), runs
the K+1 tokens [last token; drafts] through the text tower in one forward at
per-row cache slots (kernel B2 at Sq = K+1), and emits the longest draft
prefix the model itself would have produced, plus the model's next token.
Greedy outputs are token-identical to ``Engine.generate`` in exact
arithmetic: every emitted token is the verify forward's own greedy choice
(bf16 rounds the K+1-token forward differently from the 1-token one, so
identity is held in fp32).  Sampled configs use speculative sampling, exact
in distribution.  Rejected drafts' cache slots are re-marked invalid: the
next chunk overwrites them.

The JAX package runs the chunks inside one ``lax.while_loop``; here the loop
is Python, with one device-to-host copy of the rows' control fields a chunk.
Mirostat (stateful truncation) is refused; streaming takes one row.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from .generate import DecodeState, Engine
from .sampling import SamplingConfig, draw, sample_step, warped_logits


@dataclasses.dataclass
class SpecState:
    """Per-row decode state (rows advance unevenly under speculation)."""

    cache: dict
    kv_valid: torch.Tensor  # (B, Smax) bool
    cur_slot: torch.Tensor  # (B,) next cache slot per row
    positions: torch.Tensor  # (B,) next rope position per row
    gen_ids: torch.Tensor  # (B, T + K + 1)
    gen_len: torch.Tensor  # (B,)
    last_token: torch.Tensor  # (B,)
    finished: torch.Tensor  # (B,) bool
    mu: torch.Tensor  # (B,) mirostat state, passed through
    generator: torch.Generator  # speculative sampling's draws


# ---------------------------------------------------------------------------
# drafting: prompt lookup (n-gram continuation)
# ---------------------------------------------------------------------------

def ngram_draft(ctx: torch.Tensor, start, end, k: int, max_ngram: int) -> torch.Tensor:
    """Draft ``k`` tokens for each row of ``ctx`` (B, C), the token buffers
    whose valid tokens sit at [start, end) ((B,) or scalars).

    For n = 1..max_ngram (a larger n wins), find the most recent position i
    with i + n < end whose window ctx[i:i+n] equals the last n tokens
    ctx[end-n:end]; the draft is the k tokens after that window (past the
    buffer: zeros).  With no match the draft repeats the last token.  The
    JAX function's results bit for bit, its clamped slices included."""
    B, C = ctx.shape
    dev = ctx.device
    start = torch.as_tensor(start, device=dev).long().expand(B)
    end = torch.as_tensor(end, device=dev).long().expand(B)
    rows = torch.arange(B, device=dev)[:, None]
    pos = torch.arange(C, device=dev)[None, :]
    ctx_pad = torch.cat([ctx, torch.zeros(B, k, dtype=ctx.dtype, device=dev)], dim=1)
    best = torch.full((B,), -1, dtype=torch.long, device=dev)
    for n in range(1, max_ngram + 1):
        if n >= C:
            break
        t0 = (end - n).clamp(0, C - n)  # a dynamic slice of n tokens, clamped to fit
        target = ctx[rows, t0[:, None] + torch.arange(n, device=dev)[None, :]]  # (B, n)
        m = torch.ones(B, C, dtype=torch.bool, device=dev)
        for j in range(n):  # window at i covers ctx[i:i+n] (wraps; masked below)
            m &= torch.roll(ctx, -j, dims=1) == target[:, j:j + 1]
        ok = (m & (pos >= start[:, None]) & (pos + n < end[:, None])
              & (end - n >= start)[:, None])
        cand = torch.where(ok, pos, -1).amax(dim=1)
        best = torch.where(cand >= 0, cand + n, best)
    last = ctx_pad[rows[:, 0], (end - 1).clamp(0, C + k - 1)]
    s0 = best.clamp(0, C)
    drafted = ctx_pad[rows, s0[:, None] + torch.arange(k, device=dev)[None, :]]
    return torch.where(best[:, None] >= 0, drafted, last[:, None])


# ---------------------------------------------------------------------------
# verification
# ---------------------------------------------------------------------------

def _has_processors(cfg: SamplingConfig) -> bool:
    return (cfg.repetition_penalty != 1.0 or cfg.no_repeat_ngram_size > 0
            or cfg.min_new_tokens > 0)


def _verify_parallel(logits: torch.Tensor) -> torch.Tensor:
    """Pure greedy: the argmax at every chunk position at once.  (B, K+1)."""
    return logits.argmax(dim=-1)


def _hypothesis(gen_ids, gen_len, drafts) -> torch.Tensor:
    """The generated buffer with each row's drafts written at its gen_len."""
    K = drafts.shape[1]
    idx = gen_len.long()[:, None] + torch.arange(K, device=gen_ids.device)[None, :]
    return gen_ids.scatter(1, idx, drafts.to(gen_ids.dtype))


def _verify_with_processors(logits, gen_ids, gen_len, drafts, generator, mu,
                            cfg: SamplingConfig) -> torch.Tensor:
    """Greedy under context-dependent processors (repetition penalty,
    no-repeat-ngram, min-new-tokens): position j's context is the generated
    prefix plus drafts 1..j taken as accepted, which is reality up to and
    including the first mismatch, so every accepted token is what sequential
    decode would emit."""
    hyp = _hypothesis(gen_ids, gen_len, drafts)
    return torch.stack([sample_step(logits[:, j], hyp, gen_len + j, generator, mu, cfg)[0]
                        for j in range(logits.shape[1])], dim=1)


def _verify_sampled(logits, gen_ids, gen_len, drafts, generator: torch.Generator,
                    cfg: SamplingConfig) -> torch.Tensor:
    """Speculative sampling, exact in distribution.  The draft is
    deterministic (q = a delta at d), so the rule is: accept d with
    probability p(d); on rejection draw from p without d (renormalized); the
    bonus position (every draft accepted) draws from the full p."""
    B, K1, V = logits.shape
    K = K1 - 1
    hyp = _hypothesis(gen_ids, gen_len, drafts)
    low = torch.finfo(torch.float32).min
    vocab = torch.arange(V, device=logits.device)[None, :]
    preds = []
    for j in range(K1):
        w = warped_logits(logits[:, j], hyp, gen_len + j, cfg)  # (B, V)
        d = drafts[:, min(j, K - 1)].long()
        p_d = torch.gather(torch.softmax(w, dim=-1), 1, d[:, None])[:, 0]
        u = torch.rand(B, generator=generator, device=logits.device)
        accept = (u < p_d) & (j != K)
        w_masked = torch.where(vocab == d[:, None], torch.full_like(w, low), w)
        # if all the mass sat on d, rejection has measure zero but rounding
        # can still land here: resample from the full distribution then
        empty = w_masked.amax(dim=-1) <= low / 2
        full = (empty | (j == K))[:, None]
        preds.append(torch.where(accept, d, draw(torch.where(full, w, w_masked), generator)))
    return torch.stack(preds, dim=1)


def spec_chunk(engine: Engine, state: SpecState, prompt_ids: torch.Tensor,
               prompt_start: torch.Tensor, sampling: SamplingConfig, *, spec_k: int,
               max_ngram: int) -> SpecState:
    """One draft -> verify -> accept step, in place: 1..K+1 tokens a live row."""
    K = spec_k
    text = engine.model.text
    L = prompt_ids.shape[1]
    Smax = state.kv_valid.shape[1]
    dev = engine.device

    # draft
    ctx = torch.cat([prompt_ids, state.gen_ids], dim=1)
    drafts = ngram_draft(ctx, prompt_start, L + state.gen_len, K, max_ngram)
    chunk = torch.cat([state.last_token[:, None], drafts], dim=1)  # (B, K+1)

    # the chunk through the text tower at per-row slots
    ar = torch.arange(Smax, device=dev)[None, :]
    cur = state.cur_slot[:, None]
    written = (ar >= cur) & (ar < cur + K + 1)
    jj = torch.arange(K + 1, device=dev)[None, :]
    hidden, _ = text(text.embed(chunk), state.positions[:, None] + jj, state.cache,
                     state.kv_valid | written, state.cur_slot)
    logits = text.logits(hidden)  # (B, K+1, V) fp32

    # verify
    if sampling.do_sample:
        preds = _verify_sampled(logits, state.gen_ids, state.gen_len, drafts,
                                state.generator, sampling)
    elif _has_processors(sampling):
        preds = _verify_with_processors(logits, state.gen_ids, state.gen_len, drafts,
                                        state.generator, state.mu, sampling)
    else:
        preds = _verify_parallel(logits)

    # accept: the leading drafts that equal the model's choice, plus one
    match = (chunk[:, 1:] == preds[:, :-1]).long()
    acc = match.cumprod(dim=1).sum(dim=1)
    is_eos = (preds == engine.eos_token_id) & (jj <= acc[:, None])
    any_eos = is_eos.any(dim=1)
    first_eos = is_eos.long().argmax(dim=1)
    n_emit = torch.where(any_eos, torch.minimum(acc + 1, first_eos + 1), acc + 1)
    n_emit = torch.minimum(n_emit, (sampling.max_new_tokens - state.gen_len).clamp(min=0))
    n_emit = torch.where(state.finished, torch.zeros_like(n_emit), n_emit)

    out = torch.where(jj < n_emit[:, None], preds, torch.full_like(preds, engine.pad_token_id))
    idx = state.gen_len[:, None] + jj
    state.gen_ids.scatter_(1, idx, out.to(state.gen_ids.dtype))
    last = torch.gather(preds, 1, (n_emit - 1).clamp(min=0)[:, None])[:, 0]
    state.last_token = torch.where(n_emit > 0, last, state.last_token)
    # rollback: of the written slots keep [cur_slot, cur_slot + n_emit)
    state.kv_valid = torch.where(written, ar < cur + n_emit[:, None], state.kv_valid)
    state.gen_len = state.gen_len + n_emit
    state.finished = (state.finished | (any_eos & (first_eos < n_emit))
                      | (state.gen_len >= sampling.max_new_tokens))
    state.cur_slot = state.cur_slot + n_emit
    state.positions = state.positions + n_emit
    return state


# ---------------------------------------------------------------------------
# the decoder
# ---------------------------------------------------------------------------

class SpeculativeDecoder:
    """Prompt-lookup speculative generation over an :class:`Engine`.
    ``generate`` is token-identical to ``Engine.generate`` for deterministic
    configs (in exact arithmetic); ``last_stats`` holds the last call's
    chunks, tokens emitted, tokens per chunk and draft acceptance."""

    def __init__(self, engine: Engine, spec_k: int = 8, max_ngram: int = 3):
        if spec_k < 1:
            raise ValueError("spec_k must be >= 1")
        self.engine = engine
        self.spec_k = spec_k
        self.max_ngram = max_ngram
        self.last_stats: dict = {}

    def _start(self, input_ids, pixel_values, img_start_pos, sampling: SamplingConfig,
               seed: int):
        """Prefill (with K+1 slots of headroom: the last chunk may write them)
        -> (SpecState, left-padded prompt (B, Lb), first real index (B,))."""
        if sampling.do_sample and sampling.mirostat_mode == 2:
            raise ValueError("speculative decoding does not support mirostat (stateful "
                             "truncation); use Engine.generate")
        eng = self.engine
        input_ids = np.asarray(input_ids, np.int64)
        B = input_ids.shape[0]
        K = self.spec_k
        st: DecodeState = eng.start(input_ids, pixel_values, img_start_pos, sampling, seed,
                                    extra_slots=K + 1)
        padded, mask = eng.pad_prompt(input_ids)
        dev = eng.device
        gen_ids = torch.zeros(B, sampling.max_new_tokens + K + 1, dtype=torch.int64, device=dev)
        gen_ids[:, 0] = st.gen_ids[:, 0]  # the prefill emitted one token a row
        spec = SpecState(
            cache=st.cache, kv_valid=st.kv_valid,
            cur_slot=torch.full((B,), st.cur_slot, dtype=torch.int64, device=dev),
            positions=st.positions, gen_ids=gen_ids,
            gen_len=torch.ones(B, dtype=torch.int64, device=dev), last_token=st.last_token,
            finished=st.finished, mu=st.mu, generator=st.generator)
        prompt_start = torch.as_tensor(padded.shape[1] - mask.sum(axis=1), device=dev)
        return spec, torch.as_tensor(padded, device=dev), prompt_start

    def _chunk(self, spec, prompt_ids, prompt_start, sampling) -> SpecState:
        return spec_chunk(self.engine, spec, prompt_ids, prompt_start, sampling,
                          spec_k=self.spec_k, max_ngram=self.max_ngram)

    @torch.no_grad()
    def generate(self, input_ids, pixel_values=None, img_start_pos=None,
                 sampling: Optional[SamplingConfig] = None, seed: int = 0) -> np.ndarray:
        """Blocking speculative generate: Engine.generate's contract (per-row
        pads after EOS, cut at the longest row)."""
        sampling = sampling or SamplingConfig.greedy()
        spec, prompt_ids, prompt_start = self._start(input_ids, pixel_values, img_start_pos,
                                                     sampling, seed)
        B = spec.gen_len.shape[0]
        Smax = spec.kv_valid.shape[1]
        chunks = row_chunks = 0
        gen_len = np.ones(B, np.int64)
        while True:
            ctl = torch.stack([spec.finished.long(), spec.cur_slot, spec.gen_len]).cpu().numpy()
            finished, cur_slot, new_len = ctl[0].astype(bool), ctl[1], ctl[2]
            row_chunks += int((new_len > gen_len).sum())  # rows that emitted last chunk
            gen_len = new_len
            room = np.where(finished, Smax, Smax - (cur_slot + self.spec_k + 1)).min()
            if finished.all() or room < 0:
                break
            spec = self._chunk(spec, prompt_ids, prompt_start, sampling)
            chunks += 1
        emitted = int(gen_len.sum())
        # the prefill emitted B tokens outside any chunk; each live row-chunk
        # emits one token of its own and 0..K accepted drafts
        self.last_stats = {
            "chunks": chunks, "emitted": emitted,
            "tokens_per_chunk": (emitted - B) / max(chunks, 1),
            "acceptance": (emitted - B - row_chunks) / max(row_chunks * self.spec_k, 1)}
        out = spec.gen_ids[:, :int(gen_len.max())].cpu().numpy()
        for b in range(B):  # chunk writes past a row's end may hold pad or drafts
            out[b, gen_len[b]:] = self.engine.pad_token_id
        return out

    @torch.no_grad()
    def stream(self, input_ids, pixel_values=None, img_start_pos=None,
               sampling: Optional[SamplingConfig] = None,
               seed: int = 0) -> Iterator[np.ndarray]:
        """Yield (1,) token arrays like ``Engine.stream``, one verify chunk a
        device-to-host copy: each chunk can emit up to K+1 tokens."""
        sampling = sampling or SamplingConfig.greedy()
        if np.asarray(input_ids).shape[0] != 1:
            raise ValueError("speculative streaming supports batch size 1")
        spec, prompt_ids, prompt_start = self._start(input_ids, pixel_values, img_start_pos,
                                                     sampling, seed)
        yield spec.last_token.cpu().numpy()
        emitted = 1
        finished = bool(spec.finished[0])
        while not finished and emitted < sampling.max_new_tokens:
            spec = self._chunk(spec, prompt_ids, prompt_start, sampling)
            row = torch.cat([spec.gen_len, spec.finished.long(), spec.gen_ids[0]]).cpu().numpy()
            new_len, finished = int(row[0]), bool(row[1])
            if new_len == emitted:  # a finished row emitted nothing
                break
            for t in row[2 + emitted:2 + new_len]:
                yield np.asarray([t])
            emitted = new_len
