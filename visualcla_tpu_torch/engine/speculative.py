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

The JAX package runs the chunks inside one ``lax.while_loop``; here
``spec_chunk`` is one gated verify chunk over device tensors only (the
JAX loop's ``cond`` as its ``go`` flag), captured once in a CUDA graph and
replayed, ``SPEC_CHUNK`` times between host reads of one control tensor in
``generate`` (``engine/graphs.py``).  Mirostat (stateful truncation) is
refused; streaming takes one row.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from ..utils.profiling import GLOBAL_COUNTERS
from .generate import DecodeState, Engine, Workspace
from .sampling import SamplingConfig, draw, sample_step, warped_logits

SPEC_CHUNK = 4  # verify chunks (replays of the captured one) between host reads


@dataclasses.dataclass
class SpecState:
    """Per-row decode state (rows advance unevenly under speculation): views
    of the engine workspace's buffers."""

    cache: dict
    kv_valid: torch.Tensor  # (B, Smax) bool
    cur_slot: torch.Tensor  # (B,) next cache slot per row
    positions: torch.Tensor  # (B,) next rope position per row
    gen_ids: torch.Tensor  # (B, Smax) (the JAX package's is T + K + 1 wide)
    gen_len: torch.Tensor  # (B,)
    last_token: torch.Tensor  # (B,)
    finished: torch.Tensor  # (B,) bool
    mu: torch.Tensor  # (B,) mirostat state, passed through
    generator: torch.Generator  # speculative sampling's draws
    counts: torch.Tensor  # (3,) chunks run, tokens emitted by them, live row-chunks
    ws: Workspace


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
    # a Python int becomes a fill on the device: no host-to-device copy
    start, end = (x.to(dev).long().expand(B) if isinstance(x, torch.Tensor)
                  else torch.full((B,), int(x), dtype=torch.long, device=dev)
                  for x in (start, end))
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
    """One draft -> verify -> accept step over device tensors only, in place:
    1..K+1 tokens a live row.  Gated by the JAX loop's ``cond`` (not every
    row finished, room for K+1 slots): with ``go`` false it writes K/V into
    slots that are not valid and changes nothing else."""
    K = spec_k
    text = engine.model.text
    L = prompt_ids.shape[1]
    Smax = state.kv_valid.shape[1]
    dev = engine.device
    room = torch.where(state.finished, Smax, Smax - (state.cur_slot + K + 1)).amin()
    go = ~state.finished.all() & (room >= 0) & engine.graphs.enable(dev)

    # draft
    ctx = torch.cat([prompt_ids, state.gen_ids], dim=1)
    drafts = ngram_draft(ctx, prompt_start, L + state.gen_len, K, max_ngram)
    chunk = torch.cat([state.last_token[:, None], drafts], dim=1)  # (B, K+1)

    # the chunk through the text tower at per-row slots (clamped into the
    # cache as the JAX package's dynamic_update_slice clamps them)
    ar = torch.arange(Smax, device=dev)[None, :]
    cur = state.cur_slot[:, None]
    written = (ar >= cur) & (ar < cur + K + 1)
    jj = torch.arange(K + 1, device=dev)[None, :]
    hidden, _ = text(text.embed(chunk), state.positions[:, None] + jj, state.cache,
                     state.kv_valid | written, state.cur_slot.clamp(0, Smax - K - 1))
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
    n_emit = torch.where(state.finished | ~go, torch.zeros_like(n_emit), n_emit)

    out = torch.where(jj < n_emit[:, None], preds, torch.full_like(preds, engine.pad_token_id))
    idx = state.gen_len[:, None] + jj
    out = torch.where(go, out.to(state.gen_ids.dtype), state.gen_ids.gather(1, idx))
    state.gen_ids.scatter_(1, idx, out)
    last = torch.gather(preds, 1, (n_emit - 1).clamp(min=0)[:, None])[:, 0]
    state.last_token.copy_(torch.where(n_emit > 0, last, state.last_token))
    # rollback: of the written slots keep [cur_slot, cur_slot + n_emit)
    state.kv_valid.copy_(torch.where(written & go, ar < cur + n_emit[:, None],
                                     state.kv_valid))
    state.gen_len += n_emit
    state.finished |= go & ((any_eos & (first_eos < n_emit))
                            | (state.gen_len >= sampling.max_new_tokens))
    state.cur_slot += n_emit
    state.positions += n_emit
    state.counts += torch.stack((go.long(), n_emit.sum(), (n_emit > 0).sum()))
    engine.counts["spec_passes"] += 1
    return state


# ---------------------------------------------------------------------------
# the decoder
# ---------------------------------------------------------------------------

class SpeculativeDecoder:
    """Prompt-lookup speculative generation over an :class:`Engine`.
    ``generate`` is token-identical to ``Engine.generate`` for deterministic
    configs (in exact arithmetic); ``last_stats`` holds the last call's
    chunks, tokens emitted, tokens per chunk and draft acceptance.  The
    chunks replay the one captured in the engine's graphs, ``SPEC_CHUNK``
    between host reads for ``generate``, one for ``stream``."""

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
        -> (SpecState, left-padded prompt (B, Lb), first real index (B,)),
        the prompt in the workspace's buffers of its bucket."""
        if sampling.do_sample and sampling.mirostat_mode == 2:
            raise ValueError("speculative decoding does not support mirostat (stateful "
                             "truncation); use Engine.generate")
        eng = self.engine
        input_ids = np.asarray(input_ids, np.int64)
        K = self.spec_k
        st: DecodeState = eng.start(input_ids, pixel_values, img_start_pos, sampling, seed,
                                    extra_slots=K + 1)
        ws = st.ws
        try:
            return self._stage(st, input_ids)
        except BaseException:
            eng.release(ws)
            raise

    def _stage(self, st: DecodeState, input_ids):
        eng, ws = self.engine, st.ws
        padded, mask = eng.pad_prompt(input_ids)
        if padded.shape[1] not in ws.prompts:
            ws.prompts[padded.shape[1]] = (torch.zeros(padded.shape, dtype=torch.int64,
                                                       device=eng.device),
                                           torch.zeros(padded.shape[0], dtype=torch.int64,
                                                       device=eng.device))
        prompt_ids, prompt_start = ws.prompts[padded.shape[1]]
        prompt_ids.copy_(torch.as_tensor(padded))
        prompt_start.copy_(torch.as_tensor(padded.shape[1] - mask.sum(axis=1)))
        spec = SpecState(
            cache=st.cache, kv_valid=st.kv_valid, cur_slot=st.cur_slot, positions=st.positions,
            gen_ids=st.gen_ids, gen_len=st.gen_len, last_token=st.last_token,
            finished=st.finished, mu=st.mu, generator=st.generator, counts=ws.spec_counts,
            ws=ws)
        return spec, prompt_ids, prompt_start

    def _chunk(self, spec, prompt_ids, prompt_start, sampling) -> SpecState:
        """One verify chunk, eagerly."""
        return spec_chunk(self.engine, spec, prompt_ids, prompt_start, sampling,
                          spec_k=self.spec_k, max_ngram=self.max_ngram)

    def _run(self, spec, prompt_ids, prompt_start, sampling, n: int) -> None:
        """``n`` gated verify chunks: replays of the one captured on the card."""
        eng = self.engine
        key = (spec.ws.token, "spec", prompt_ids.shape[1], sampling, self.spec_k,
               self.max_ngram)
        eng.graphs.run(key, lambda: self._chunk(spec, prompt_ids, prompt_start, sampling),
                       eng.device, generators=[spec.generator], counters=[eng.counts],
                       replays=n)

    def _control(self, spec) -> np.ndarray:
        """[loop's cond, chunks, emitted by chunks, row-chunks, gen_len (B,)]:
        one device-to-host copy."""
        Smax = spec.kv_valid.shape[1]
        room = torch.where(spec.finished, Smax, Smax - (spec.cur_slot + self.spec_k + 1))
        cond = ~spec.finished.all() & (room.amin() >= 0)
        return torch.cat([cond.long()[None], spec.counts, spec.gen_len]).cpu().numpy()

    @torch.no_grad()
    def generate(self, input_ids, pixel_values=None, img_start_pos=None,
                 sampling: Optional[SamplingConfig] = None, seed: int = 0) -> np.ndarray:
        """Blocking speculative generate: Engine.generate's contract (per-row
        pads after EOS, cut at the longest row), its phases timed on the
        engine's ``timer``; adds ``generated_tokens``, ``requests`` and
        ``spec_chunks`` to ``GLOBAL_COUNTERS``, as the JAX decoder does."""
        eng = self.engine
        sampling = sampling or SamplingConfig.greedy()
        with eng.timer.phase("prefill") as p:
            spec, prompt_ids, prompt_start = self._start(input_ids, pixel_values,
                                                         img_start_pos, sampling, seed)
            p["sync_on"] = spec.last_token
        try:
            B = spec.gen_len.shape[0]
            with eng.timer.phase("decode"):
                ctl = self._control(spec)
                while ctl[0]:
                    self._run(spec, prompt_ids, prompt_start, sampling, SPEC_CHUNK)
                    ctl = self._control(spec)
            chunks, emitted, row_chunks = int(ctl[1]), B + int(ctl[2]), int(ctl[3])
            gen_len = ctl[4:]
            # the prefill emitted B tokens outside any chunk; each live
            # row-chunk emits one token of its own and 0..K accepted drafts
            self.last_stats = {
                "chunks": chunks, "emitted": emitted,
                "tokens_per_chunk": (emitted - B) / max(chunks, 1),
                "acceptance": (emitted - B - row_chunks) / max(row_chunks * self.spec_k, 1)}
            out = spec.gen_ids[:, :int(gen_len.max())].cpu().numpy().copy()
        finally:
            eng.release(spec.ws)
        GLOBAL_COUNTERS.add("generated_tokens", int(gen_len.sum()))
        GLOBAL_COUNTERS.add("requests", B)
        GLOBAL_COUNTERS.add("spec_chunks", chunks)
        for b in range(B):  # chunk writes past a row's end may hold pad or drafts
            out[b, gen_len[b]:] = eng.pad_token_id
        return out

    def stream(self, input_ids, pixel_values=None, img_start_pos=None,
               sampling: Optional[SamplingConfig] = None,
               seed: int = 0) -> Iterator[np.ndarray]:
        """Yield (1,) token arrays like ``Engine.stream``, one captured verify
        chunk a device-to-host copy: each chunk can emit up to K+1 tokens."""
        sampling = sampling or SamplingConfig.greedy()
        if np.asarray(input_ids).shape[0] != 1:
            raise ValueError("speculative streaming supports batch size 1")
        with torch.no_grad():
            spec, prompt_ids, prompt_start = self._start(input_ids, pixel_values,
                                                         img_start_pos, sampling, seed)
        try:
            yield spec.last_token.cpu().numpy()
            emitted = 1
            finished = bool(spec.finished[0])
            while not finished and emitted < sampling.max_new_tokens:
                with torch.no_grad():
                    self._run(spec, prompt_ids, prompt_start, sampling, 1)
                row = torch.cat([spec.gen_len, spec.finished.long(),
                                 spec.gen_ids[0]]).cpu().numpy()
                new_len, finished = int(row[0]), bool(row[1])
                if new_len == emitted:  # a finished row emitted nothing
                    break
                for t in row[2 + emitted:2 + new_len]:
                    yield np.asarray([t])
                emitted = new_len
        finally:
            self.engine.release(spec.ws)
