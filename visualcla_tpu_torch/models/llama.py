"""LLaMA decoder (port of visualcla_tpu/models/llama.py).

Numerics as the JAX package: fp32 RMSNorm statistics, fp32 rope tables, fp32
softmax, fp32 logits.  One ``forward`` covers prefill and decode: the KV
cache is a fixed (L, B, Nkv, S, hd) buffer per tensor, each layer writes its
chunk's K/V at ``(l, write_slot)`` in place and then attends over layer ``l``
of the whole buffer (``ops.attention.cached_attention``: the CUDA kernels B1
and B2 on the card).  ``kv_quant="int8"`` stores the cache in int8 with
per-token-per-head f32 scales (L, B, Nkv, S).  ``quant`` builds the text
tower at the int8 or int4 weight tier (``ops.linear``): every layer matmul
and the LM head quantized, the embedding table per-row int8.  Causality
follows cache slot order, so left-padded
rows work; ``rope_positions`` carries the HF position ids.  The cache-free
training forward (``kv_cache=None``) is not ported yet.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import LlamaConfig

from ..ops.activations import ACT2FN
from ..ops.attention import cached_attention
from ..ops.cuda.flash_attention import slot_vector
from ..ops.linear import Int8Table, make_linear
from ..ops.norms import RMSNorm
from ..ops.quantization import quantize_kv
from ..ops.rope import apply_rope, rope_table

WriteSlot = Union[int, torch.Tensor]  # int, or (B,) per-row slots


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int, dtype, *,
                  device=None, kv_quant: str = "none") -> dict:
    """Zeroed {'k', 'v'} buffers of shape (L, B, Nkv, max_len, hd) in the
    model's dtype; ``kv_quant="int8"``: int8 buffers plus {'k_scale',
    'v_scale'} (L, B, Nkv, max_len) f32 scales that start at one."""
    shape = (cfg.num_hidden_layers, batch, cfg.num_key_value_heads, max_len, cfg.head_dim)
    if kv_quant == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.ones(shape[:-1], dtype=torch.float32, device=device),
                "v_scale": torch.ones(shape[:-1], dtype=torch.float32, device=device)}
    if kv_quant != "none":
        raise ValueError(f"unknown kv_quant {kv_quant!r}")
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def put_chunk(buf: torch.Tensor, chunk: torch.Tensor, l: int,
              write_slot: WriteSlot) -> None:
    """Write chunk (B, Nkv, Sq[, hd]) into buf (L, B, Nkv, S[, hd]) at layer
    l, slots ``write_slot + [0, Sq)``, in place (values or int8 scales)."""
    Sq = chunk.shape[2]
    if not isinstance(write_slot, torch.Tensor):
        buf[l, :, :, write_slot:write_slot + Sq] = chunk
        return
    B = chunk.shape[0]
    rows = torch.arange(B, device=buf.device)[:, None]
    idx = write_slot.to(buf.device).long().reshape(-1, 1) + torch.arange(
        Sq, device=buf.device)[None, :]
    # (B, S, Nkv[, hd]) view of the layer: advanced indexing writes through it
    buf[l].transpose(1, 2)[rows, idx] = chunk.transpose(1, 2)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, device=None, dtype=None, quant: str = "none"):
        super().__init__()
        H, I = cfg.hidden_size, cfg.intermediate_size
        N, Nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        kw = dict(device=device, dtype=dtype)
        lin = dict(quant=quant, **kw)
        self.cfg = cfg
        self.act = ACT2FN[cfg.hidden_act]
        self.input_norm = RMSNorm(H, cfg.rms_norm_eps, **kw)
        self.q_proj = make_linear(H, N * hd, **lin)
        self.k_proj = make_linear(H, Nkv * hd, **lin)
        self.v_proj = make_linear(H, Nkv * hd, **lin)
        self.o_proj = make_linear(N * hd, H, **lin)
        self.post_norm = RMSNorm(H, cfg.rms_norm_eps, **kw)
        self.gate_proj = make_linear(H, I, **lin)
        self.up_proj = make_linear(H, I, **lin)
        self.down_proj = make_linear(I, H, **lin)

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
        k, v = k.transpose(1, 2), v.transpose(1, 2)  # cache order (B, Nkv, Sq, hd)
        if "k_scale" in cache:  # int8 cache: K and V quantized per token and head, together
            (kq, vq), (ks, vs) = (t.unbind(0) for t in quantize_kv(torch.stack((k, v))))
            writes = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        else:
            writes = {"k": k.to(cache["k"].dtype), "v": v.to(cache["v"].dtype)}
        for name, chunk in writes.items():
            put_chunk(cache[name], chunk, l, write_slot)
        attn = cached_attention(q, cache["k"], cache["v"], kv_valid, slots,
                                k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"),
                                layer_index=l)
        h = h + self.o_proj(attn.reshape(B, Sq, N * hd))
        x2 = self.post_norm(h)
        return h + self.down_proj(self.act(self.gate_proj(x2)) * self.up_proj(x2))


class Llama(nn.Module):
    """``quant``: the text tower's weight tier, "none" (dense), "int8" or "int4"."""

    def __init__(self, cfg: LlamaConfig, *, device=None, dtype=None, quant: str = "none"):
        super().__init__()
        if cfg.attention_bias:
            raise NotImplementedError("attention_bias=true checkpoints are not supported")
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        if quant == "none":
            self.embed_tokens = nn.Parameter(
                torch.empty(cfg.vocab_size, cfg.hidden_size, **kw), requires_grad=False)
        else:
            self.embed_tokens = Int8Table(cfg.vocab_size, cfg.hidden_size, device=device)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, quant=quant, **kw)
            for _ in range(cfg.num_hidden_layers))
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)
        self.lm_head = make_linear(cfg.hidden_size, cfg.vocab_size, quant, **kw)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        """(B, S) ids -> (B, S, H) in the model's dtype."""
        if isinstance(self.embed_tokens, Int8Table):
            return self.embed_tokens(input_ids).to(self.final_norm.weight.dtype)
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
        """LM head, accumulated and returned in fp32 (dense, int8 or int4)."""
        return self.lm_head.forward_f32(hidden)

    def forward_logits(self, input_ids: torch.Tensor,
                       attention_mask: Optional[torch.Tensor] = None,
                       kv_quant: str = "none") -> torch.Tensor:
        """Full-sequence forward for tests: (B, S) ids -> (B, S, V) logits."""
        B, S = input_ids.shape
        if attention_mask is None:
            attention_mask = torch.ones(B, S, dtype=torch.int64, device=input_ids.device)
        positions = (attention_mask.long().cumsum(-1) - 1).clamp(min=0)
        cache = init_kv_cache(self.cfg, B, S, self.final_norm.weight.dtype,
                              device=input_ids.device, kv_quant=kv_quant)
        h, _ = self(self.embed(input_ids), positions, cache, attention_mask.bool(), 0)
        return self.logits(h)
