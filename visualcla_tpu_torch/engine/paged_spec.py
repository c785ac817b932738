"""Speculative decoding inside the paged pool (port of
visualcla_tpu/engine/paged_spec.py).

Each speculative iteration of ``PagedServingEngine.spec_step_n``:

  draft    per row, k tokens by prompt lookup over the row's whole token
           history (prompt and generated, ``PagedState.all_ids``);
  verify   one forward of the (B, k+1) tokens [last token; drafts] through
           the text tower; token j sits at rope position positions + j and
           appends its K/V at pool slot lens + j, and kernel B5 attends query
           j over the slots <= lens + j, once a layer.  Rejected slots need no
           rollback: a later step rewrites them before any query sees them;
  accept   rows that are a pure argmax chain (``spec_eligible``) commit the
           longest draft prefix matching the model's own argmax chain plus
           one token; every other running row commits exactly one token from
           the j = 0 logits through the same row-wise sampler as the plain
           step.  (``PagedServingEngine._spec_finish``.)
"""
from __future__ import annotations

import torch

from ..ops.cuda.paged_attention import paged_verify_attention
from .paged import PagedState, pool_kv
from .speculative import ngram_draft


def draft_all_rows(all_ids: torch.Tensor, total_len: torch.Tensor, k: int,
                   max_ngram: int) -> torch.Tensor:
    """(B, C) token history + (B,) valid lengths -> (B, k) drafts."""
    return ngram_draft(all_ids, 0, total_len, k, max_ngram)


def paged_verify_forward(text, embeds, positions, state: PagedState, tables, base,
                         run) -> torch.Tensor:
    """Forward (B, Sq) tokens over the pool, kernel B5 in every layer: embeds
    (B, Sq, H), positions (B, Sq) rope positions, base (B,) the pool slot of
    token 0 (token j goes to slot base + j), run (B,) the running rows.  The
    pools are updated in place, in the pool's format (``pool_kv``).  Parked
    rows pass length Sq over a ZEROED table (a row mid-way through a chunked
    admission has its blocks reserved and its prompt half written), so they
    touch only dummy block 0, as do slots past a row's table.  The tower's
    own pass (``Llama.paged_decode``).  -> final-normed hidden (B, Sq, H)."""
    Sq = embeds.shape[1]
    lens_total = torch.where(run, base + Sq, torch.full_like(base, Sq))
    tables = torch.where(run[:, None], tables, torch.zeros_like(tables))

    def attend(l, q, k, v):
        k, v, ksc, vsc = pool_kv(state, k, v)
        return paged_verify_attention(q, k, v, state.k_pool, state.v_pool, tables, lens_total,
                                      l, ksc, vsc, state.k_scales, state.v_scales)

    return text.paged_decode(embeds, positions, state, attend, run)


def spec_eligible(knobs):
    """(B,) rows whose committed tokens are a pure argmax chain, the rows
    speculative acceptance is exact for, from (B, 11) knob rows
    (``pool.sampling_knobs`` order; numpy on the host or a device tensor):
    no sampling, repetition penalty, n-gram ban, mirostat or top-k."""
    return ((knobs[:, 3] <= 0.5) & (knobs[:, 2] == 1.0) & (knobs[:, 10] == 0)
            & (knobs[:, 6] <= 1.5) & (knobs[:, 9] == 0))
