"""Attention ops (port of visualcla_tpu/ops/attention.py).

``dot_product_attention`` is the numerics-defining dense path (fp32 softmax,
HF eager attention); ``full_attention`` is the bidirectional attention of the
ViT and the resampler, dense by default and the flash kernel B2u with
``VISUALCLA_VIT_ATTN=flash`` unless ``attention_impl_scope`` pins a backend
on the calling thread; ``cached_attention`` is the LLM's attention over
the stacked KV cache, which goes to the flash kernels B1 (decode) and B2
(prefill), or over one layer's bnsh K/V (B1 or B2u).  Every function keeps
the JAX package's (B, S, N, hd) layout.
"""
from __future__ import annotations

import contextlib
import os
import threading
from typing import Optional

import torch

from ..parallel import tp
from .cuda.flash_attention import (flash_attention, flash_attention_ref, flash_decode_stacked,
                                   flash_decode_stacked_ref, flash_prefill_stacked,
                                   flash_prefill_stacked_ref)

NEG_INF = torch.finfo(torch.float32).min
_TLS = threading.local()


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


@contextlib.contextmanager
def attention_impl_scope(name: str):
    """Pin ``full_attention``'s backend on this thread for the block
    (``"xla"``: dense, ``"flash"``: kernel B2u), over ``VISUALCLA_VIT_ATTN``.
    Training pins ``"xla"``: the kernels have no backward."""
    if name not in ("flash", "xla"):
        raise ValueError(f"attention impl must be 'flash' or 'xla', got {name!r}")
    stack = getattr(_TLS, "impl_override", None)
    if stack is None:
        stack = _TLS.impl_override = []
    stack.append(name)
    try:
        yield
    finally:
        stack.pop()


def current_attention_mesh():
    """The mesh in effect on the calling thread: its innermost
    ``attention_mesh_scope``, else None."""
    stack = getattr(_TLS, "mesh_override", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def attention_mesh_scope(mesh):
    """Put ``mesh`` (which may be None) in effect on this thread for the
    block: the engines run every program under their own mesh's scope, so a
    meshed and an unmeshed engine in one process never see each other's.
    Thread-local: the serving Scheduler steps its engine on its own thread."""
    stack = getattr(_TLS, "mesh_override", None)
    if stack is None:
        stack = _TLS.mesh_override = []
    stack.append(mesh)
    try:
        yield
    finally:
        stack.pop()


def _flash_sharded(q, k, v, kv_valid, write_slot, mesh, *, k_scale=None, v_scale=None):
    """B2u's mesh form (the JAX package's ``_flash_sharded``): causal flash
    attention of the whole (B, Sq, N, hd) q over the whole bnsh (B, Nkv, S,
    hd) K/V (int8 with (B, Nkv, S) scales), every rank running kernel B2u (B1
    at Sq == 1) on its rows (``data``) and kv heads (``model``) and the
    output gathered back whole.  Heads are independent, so no other
    collective runs.  -> None where the mesh lacks ``data`` or ``model``
    (a ('data', 'seq') mesh) or the heads or rows do not divide, as in the
    JAX package: the caller then runs B2u on the whole arrays, which every
    rank holds."""
    data, model = tp.axis(mesh, "data"), tp.axis(mesh, "model")
    if data is None or model is None:
        return None
    B, _, N, _ = q.shape
    Nkv = k.shape[1]
    if N % model.size or Nkv % model.size or B % data.size:
        return None

    def part(x, ax, dim):
        if x is None or (isinstance(x, torch.Tensor) and x.dim() == 0):
            return x
        w = x.shape[dim] // ax.size
        return x.narrow(dim, ax.rank * w, w)

    q_l = part(part(q, data, 0), model, 2)
    k_l, v_l = (part(part(t, data, 0), model, 1) for t in (k, v))
    ks_l, vs_l = (part(part(t, data, 0), model, 1) for t in (k_scale, v_scale))
    slot = write_slot
    if isinstance(slot, torch.Tensor) and slot.dim() == 1:
        slot = part(slot, data, 0)
    out = flash_attention(q_l, k_l, v_l, part(kv_valid, data, 0), slot, causal=True,
                          k_scale=ks_l, v_scale=vs_l, kv_layout="bnsh")
    out = tp.gather_from_model(out, model.group, model.size, dim=2)
    return tp.gather_from_model(out, data.group, data.size, dim=0)


def vision_attention_impl() -> str:
    """The backend ``full_attention`` runs: the innermost
    ``attention_impl_scope`` of this thread, else ``VISUALCLA_VIT_ATTN``
    (``"xla"``, the dense default, or ``"flash"``): part of a captured
    encode's key."""
    stack = getattr(_TLS, "impl_override", None)
    if stack:
        return stack[-1]
    return os.environ.get("VISUALCLA_VIT_ATTN", "xla")


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   softmax_dtype: str = "fp32", impl: Optional[str] = None) -> torch.Tensor:
    """Bidirectional unmasked attention (ViT / resampler).  ``impl=None``
    reads ``vision_attention_impl()`` at call time (the JAX package's
    default, ``"xla"``, is the dense path).  ``"flash"`` runs kernel B2u with causal off,
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


def padding_bias(kv_valid: torch.Tensor) -> torch.Tensor:
    """Additive fp32 bias (B, 1, 1, Sk) masking invalid kv slots (bidirectional)."""
    bias = torch.zeros(kv_valid.shape, dtype=torch.float32, device=kv_valid.device)
    return bias.masked_fill(~kv_valid.bool(), NEG_INF)[:, None, None, :]


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
    without a mesh: Sq == 1 goes to B1, Sq > 1 to B2u (causal); under an
    ``attention_mesh_scope`` whose rows and heads divide, each rank runs
    them on its shard (``_flash_sharded``), else on the whole arrays, which
    every rank holds.  On the stacked cache every rank holds its own shard
    already and runs B1 / B2 in place."""
    if layer_index is None:
        mesh = current_attention_mesh()
        out = None if mesh is None else _flash_sharded(
            q, k_cache, v_cache, kv_valid, write_slot, mesh, k_scale=k_scale, v_scale=v_scale)
        if out is None:
            out = flash_attention(q, k_cache, v_cache, kv_valid, write_slot, causal=True,
                                  k_scale=k_scale, v_scale=v_scale, kv_layout="bnsh")
        return out
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

