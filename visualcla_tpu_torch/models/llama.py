"""LLaMA decoder (port of visualcla_tpu/models/llama.py).

Numerics as the JAX package: fp32 RMSNorm statistics, fp32 rope tables, fp32
softmax, fp32 logits.  One ``forward`` covers prefill and decode: the KV
cache is a fixed (L, B, Nkv, S, hd) buffer per tensor, each layer writes its
chunk's K/V at ``(l, write_slot)`` in place and then attends over layer ``l``
of the whole buffer (``ops.attention.cached_attention``: the CUDA kernels B1
and B2 on the card).  Causality follows cache slot order, so left-padded
rows work; ``rope_positions`` carries the HF position ids.  The cache-free
training forward (``kv_cache=None``) is not ported yet.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from visualcla_tpu.core.config import LlamaConfig

from ..ops.activations import ACT2FN
from ..ops.attention import cached_attention
from ..ops.cuda.flash_attention import slot_vector
from ..ops.linear import Linear
from ..ops.norms import RMSNorm
from ..ops.rope import apply_rope, rope_table

WriteSlot = Union[int, torch.Tensor]  # int, or (B,) per-row slots


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int, dtype, *,
                  device=None) -> dict:
    """Zeroed {'k', 'v'} buffers of shape (L, B, Nkv, max_len, hd), in the
    model's dtype (the int8 cache is ROADMAP item 1)."""
    shape = (cfg.num_hidden_layers, batch, cfg.num_key_value_heads, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def put_chunk(buf: torch.Tensor, chunk: torch.Tensor, l: int,
              write_slot: WriteSlot) -> None:
    """Write chunk (B, Nkv, Sq, hd) into buf (L, B, Nkv, S, hd) at layer l,
    slots ``write_slot + [0, Sq)``, in place."""
    Sq = chunk.shape[2]
    if not isinstance(write_slot, torch.Tensor):
        buf[l, :, :, write_slot:write_slot + Sq] = chunk
        return
    B = chunk.shape[0]
    rows = torch.arange(B, device=buf.device)[:, None]
    idx = write_slot.to(buf.device).long().reshape(-1, 1) + torch.arange(
        Sq, device=buf.device)[None, :]
    # (B, S, Nkv, hd) view of the layer: advanced indexing writes through it
    buf[l].permute(0, 2, 1, 3)[rows, idx] = chunk.permute(0, 2, 1, 3)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, device=None, dtype=None):
        super().__init__()
        H, I = cfg.hidden_size, cfg.intermediate_size
        N, Nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.act = ACT2FN[cfg.hidden_act]
        self.input_norm = RMSNorm(H, cfg.rms_norm_eps, **kw)
        self.q_proj = Linear(H, N * hd, False, **kw)
        self.k_proj = Linear(H, Nkv * hd, False, **kw)
        self.v_proj = Linear(H, Nkv * hd, False, **kw)
        self.o_proj = Linear(N * hd, H, False, **kw)
        self.post_norm = RMSNorm(H, cfg.rms_norm_eps, **kw)
        self.gate_proj = Linear(H, I, False, **kw)
        self.up_proj = Linear(H, I, False, **kw)
        self.down_proj = Linear(I, H, False, **kw)

    def forward(self, h, cos, sin, cache: dict, kv_valid, write_slot: WriteSlot,
                slots: torch.Tensor, l: int) -> torch.Tensor:
        """qkv -> rope -> cache write at (l, write_slot) -> attention over the
        cache -> mlp.  ``slots`` is write_slot as a (B,) int32 tensor."""
        B, Sq, _ = h.shape
        cfg = self.cfg
        N, Nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        x = self.input_norm(h)
        q = self.q_proj(x).reshape(B, Sq, N, hd)
        k = self.k_proj(x).reshape(B, Sq, Nkv, hd)
        v = self.v_proj(x).reshape(B, Sq, Nkv, hd)
        q, k = apply_rope(q, k, cos, sin)
        for name, chunk in (("k", k), ("v", v)):  # cache order (B, Nkv, Sq, hd)
            put_chunk(cache[name], chunk.transpose(1, 2).to(cache[name].dtype), l,
                      write_slot)
        attn = cached_attention(q, cache["k"], cache["v"], kv_valid, slots,
                                layer_index=l)
        h = h + self.o_proj(attn.reshape(B, Sq, N * hd))
        x2 = self.post_norm(h)
        return h + self.down_proj(self.act(self.gate_proj(x2)) * self.up_proj(x2))


class Llama(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, device=None, dtype=None):
        super().__init__()
        if cfg.attention_bias:
            raise NotImplementedError("attention_bias=true checkpoints are not supported")
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.embed_tokens = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.hidden_size, **kw), requires_grad=False)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, **kw) for _ in range(cfg.num_hidden_layers))
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)
        self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size, False, **kw)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        """(B, S) ids -> (B, S, H)."""
        return F.embedding(input_ids, self.embed_tokens)

    def forward(
        self,
        inputs_embeds: torch.Tensor,  # (B, Sq, H)
        rope_positions: torch.Tensor,  # (B, Sq) integer
        kv_cache: Optional[dict],  # see init_kv_cache; written in place
        kv_valid: torch.Tensor,  # (B, S) bool — valid AFTER this chunk is written
        write_slot: WriteSlot,  # cache slot of the chunk's first token
    ) -> Tuple[torch.Tensor, dict]:
        """Run the decoder stack: (final-normed hidden (B, Sq, H), kv_cache)."""
        if kv_cache is None:
            raise NotImplementedError(
                "the cache-free training forward is not ported yet (ROADMAP, "
                "open item 10: training)")
        cfg = self.cfg
        B = inputs_embeds.shape[0]
        cos, sin = rope_table(rope_positions, cfg.head_dim, cfg.rope_theta)
        slots = slot_vector(write_slot, B, inputs_embeds.device)  # once, not per layer
        h = inputs_embeds
        for l, layer in enumerate(self.layers):
            h = layer(h, cos, sin, kv_cache, kv_valid, write_slot, slots, l)
        return self.final_norm(h), kv_cache

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """LM head, accumulated and returned in fp32."""
        w = self.lm_head.weight
        if hidden.dtype == torch.float32:
            return F.linear(hidden, w.float())
        if hidden.is_cuda:
            # fp32 accumulation and output without an fp32 copy of the head
            flat = torch.mm(hidden.reshape(-1, hidden.shape[-1]), w.t(),
                            out_dtype=torch.float32)
            return flat.reshape(*hidden.shape[:-1], w.shape[0])
        return F.linear(hidden.float(), w.float())

    def forward_logits(self, input_ids: torch.Tensor,
                       attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Full-sequence forward for tests: (B, S) ids -> (B, S, V) logits."""
        B, S = input_ids.shape
        if attention_mask is None:
            attention_mask = torch.ones(B, S, dtype=torch.int64, device=input_ids.device)
        positions = (attention_mask.long().cumsum(-1) - 1).clamp(min=0)
        cache = init_kv_cache(self.cfg, B, S, self.final_norm.weight.dtype,
                              device=input_ids.device)
        h, _ = self(self.embed(input_ids), positions, cache, attention_mask.bool(), 0)
        return self.logits(h)
