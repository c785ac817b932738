"""Attention ops (port of visualcla_tpu/ops/attention.py).

``dot_product_attention`` is the numerics-defining dense path (fp32 softmax,
HF eager attention); ``full_attention`` is the bidirectional attention of the
ViT and the resampler, dense by default and the flash kernel B2u with
``VISUALCLA_VIT_ATTN=flash``; ``cached_attention`` is the LLM's attention over
the stacked KV cache, which goes to the flash kernels B1 (decode) and B2
(prefill), or over one layer's bnsh K/V (B1 or B2u).  Every function keeps
the JAX package's (B, S, N, hd) layout.
"""
from __future__ import annotations

from typing import Optional

import os

import torch

from .cuda.flash_attention import (flash_attention, flash_attention_ref, flash_decode_stacked,
                                   flash_decode_stacked_ref, flash_prefill_stacked,
                                   flash_prefill_stacked_ref)

NEG_INF = torch.finfo(torch.float32).min


def dot_product_attention(
    q: torch.Tensor,  # (B, Sq, N, hd)
    k: torch.Tensor,  # (B, Sk, Nkv, hd)
    v: torch.Tensor,  # (B, Sk, Nkv, hd)
    bias: Optional[torch.Tensor] = None,  # (B, 1|N, Sq, Sk) additive
    scale: Optional[float] = None,
    softmax_dtype: str = "fp32",
) -> torch.Tensor:
    """Dense attention, (B, Sq, N, hd) in q's dtype.

    Scores are computed in promote(q.dtype, fp32); the softmax runs in fp32
    (``"fp32"``, HF eager) or in promote(q.dtype, fp32) (``"native"``, the
    resampler's input-dtype softmax kept bf16-safe); the probabilities are
    cast back to q's dtype before the product with V."""
    n, hd = q.shape[2], q.shape[3]
    nkv = k.shape[2]
    if n != nkv:  # grouped-query: repeat kv heads
        k = k.repeat_interleave(n // nkv, dim=2)
        v = v.repeat_interleave(n // nkv, dim=2)
    if scale is None:
        scale = hd ** -0.5
    score_dtype = torch.promote_types(q.dtype, torch.float32)
    acc = torch.float32 if softmax_dtype == "fp32" else score_dtype
    logits = torch.einsum("bqnh,bknh->bnqk", q.to(score_dtype), k.to(score_dtype))
    logits = logits * scale
    if bias is not None:
        logits = logits + bias.to(logits.dtype)
    probs = torch.softmax(logits.to(acc), dim=-1).to(q.dtype)
    return torch.einsum("bnqk,bknh->bqnh", probs, v)


def vision_attention_impl() -> str:
    """``VISUALCLA_VIT_ATTN`` as ``full_attention`` reads it (``"xla"``, the
    dense default, or ``"flash"``): part of a captured encode's key."""
    return os.environ.get("VISUALCLA_VIT_ATTN", "xla")


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   softmax_dtype: str = "fp32", impl: Optional[str] = None) -> torch.Tensor:
    """Bidirectional unmasked attention (ViT / resampler).  ``impl=None``
    reads ``VISUALCLA_VIT_ATTN`` at call time with the JAX package's default,
    ``"xla"``: the dense path.  ``"flash"`` runs kernel B2u with causal off,
    every slot valid, over the bsnh K/V in place; it keeps p in fp32 and so
    ignores ``softmax_dtype``, as the JAX package's flash path does."""
    if impl is None:
        impl = vision_attention_impl()
    if impl == "flash":
        B, Skv = k.shape[0], k.shape[1]
        kv_valid = torch.ones(B, Skv, dtype=torch.bool, device=q.device)
        return flash_attention(q, k, v, kv_valid, 0, causal=False)
    return dot_product_attention(q, k, v, softmax_dtype=softmax_dtype)


def causal_bias(
    q_positions: torch.Tensor,  # (B, Sq) absolute positions of queries
    kv_valid: torch.Tensor,  # (B, Sk) bool
    kv_positions: torch.Tensor,  # (B, Sk) absolute positions of kv slots
) -> torch.Tensor:
    """Additive fp32 bias (B, 1, Sq, Sk): causal + validity masking."""
    ok = kv_valid[:, None, :] & (kv_positions[:, None, :] <= q_positions[:, :, None])
    bias = torch.where(ok, torch.tensor(0.0, device=ok.device),
                       torch.tensor(NEG_INF, device=ok.device))
    return bias.float()[:, None, :, :]


def cached_attention(
    q: torch.Tensor,  # (B, Sq, N, hd)
    k_cache: torch.Tensor,  # (L, B, Nkv, S, hd) — the FULL stacked cache (int8 or q's dtype),
    v_cache: torch.Tensor,  # or one layer (B, Nkv, S, hd) with layer_index=None
    kv_valid: torch.Tensor,  # (B, S) bool
    write_slot,  # int, () or (B,) — cache slot of the first query
    *,
    k_scale: Optional[torch.Tensor] = None,  # (L, B, Nkv, S) | (B, Nkv, S) f32 for int8 k/v
    v_scale: Optional[torch.Tensor] = None,
    layer_index: Optional[int] = None,
) -> torch.Tensor:
    """Causal attention of q over layer ``layer_index`` of the stacked cache.
    Query i sits at slot ``write_slot + i`` and sees the valid kv slots up to
    its own.  Sq == 1 goes to the decode kernel (B1), Sq > 1 to the prefill
    kernel (B2), both reading an int8 cache with its scales in place; on CPU
    tensors both run their plain PyTorch versions.  ``layer_index=None``
    takes one layer's bnsh K/V, the JAX package's single-device contract
    without a mesh: Sq == 1 goes to B1, Sq > 1 to B2u (causal)."""
    if layer_index is None:
        return flash_attention(q, k_cache, v_cache, kv_valid, write_slot, causal=True,
                               k_scale=k_scale, v_scale=v_scale, kv_layout="bnsh")
    fn = flash_decode_stacked if q.shape[1] == 1 else flash_prefill_stacked
    return fn(q, k_cache, v_cache, kv_valid, write_slot, layer_index,
              k_scale=k_scale, v_scale=v_scale)


def cached_attention_ref(q, k_cache, v_cache, kv_valid, write_slot, *, k_scale=None,
                         v_scale=None, layer_index=None):
    """``cached_attention`` through the kernels' plain PyTorch versions, on any
    device: what the kernels are held against end to end."""
    if layer_index is None:
        return flash_attention_ref(q, k_cache, v_cache, kv_valid, write_slot, causal=True,
                                   k_scale=k_scale, v_scale=v_scale, kv_layout="bnsh")
    fn = flash_decode_stacked_ref if q.shape[1] == 1 else flash_prefill_stacked_ref
    return fn(q, k_cache, v_cache, kv_valid, write_slot, layer_index,
              k_scale=k_scale, v_scale=v_scale)
