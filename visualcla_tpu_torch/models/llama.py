"""LLaMA decoder (port of visualcla_tpu/models/llama.py).

Numerics as the JAX package: fp32 RMSNorm statistics, fp32 rope tables, fp32
softmax, fp32 logits.  One ``forward`` covers prefill and decode: the KV
cache is a fixed (L, B, Nkv, S, hd) buffer per tensor, each layer writes its
chunk's K/V at ``(l, write_slot)`` in place and then attends over layer ``l``
of the whole buffer (``ops.attention.cached_attention``: the CUDA kernels B1
and B2 on the card).  ``kv_quant="int8"`` stores the cache in int8 with
per-token-per-head f32 scales (L, B, Nkv, S).  ``quant`` builds the text
tower at the int8 or int4 weight tier (``ops.linear``): every layer matmul
quantized, and with them the LM head and the embedding table (per-row int8)
unless ``head_quant="none"`` keeps those two in float (the QLoRA tree, where
they train).  Causality follows cache slot order, so left-padded rows work;
``rope_positions`` carries the HF position ids.  ``kv_cache=None`` is the
cache-free training forward: each layer attends over its own chunk's K/V
(``chunk_causal_attention``), and ``remat=True`` recomputes each layer in
the backward (``torch.utils.checkpoint``), as ``jax.checkpoint`` does there.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..core.config import LlamaConfig

from ..ops.activations import ACT2FN
from ..ops.attention import cached_attention
from ..ops.cuda.flash_attention import slot_vector
from ..ops.linear import Int8Table, make_linear
from ..ops.norms import RMSNorm
from ..ops.quantization import quantize_kv
from ..ops.rope import apply_rope, rope_table
from ..parallel import fsdp, tp
from ..parallel.ring import ring_attention

WriteSlot = Union[int, torch.Tensor]  # int, or (B,) per-row slots


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int, dtype, *,
                  device=None, kv_quant: str = "none", kv_heads: Optional[int] = None) -> dict:
    """Zeroed {'k', 'v'} buffers of shape (L, B, Nkv, max_len, hd) in the
    model's dtype; ``kv_quant="int8"``: int8 buffers plus {'k_scale',
    'v_scale'} (L, B, Nkv, max_len) f32 scales that start at one.
    ``kv_heads``: the heads a rank holds over a mesh (``Llama.kv_heads``;
    default the config's)."""
    nkv = cfg.num_key_value_heads if kv_heads is None else kv_heads
    shape = (cfg.num_hidden_layers, batch, nkv, max_len, cfg.head_dim)
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


def chunk_causal_attention(q, k, v, valid):
    """Causal attention over a chunk's own K/V (the cache-free training
    path).  q (B, Sq, N, hd); k, v (B, Nkv, Sq, hd) in cache order; valid
    (B, Sq) bool.  fp32 scores and softmax, masked entries filled with -1e30:
    query i sees the valid kv j <= i.  -> (B, Sq, N, hd) in q's dtype."""
    B, Sq, N, hd = q.shape
    rep = N // k.shape[1]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    s = torch.einsum("binh,bnjh->bnij", q.float(), k.float()) * (1.0 / float(hd) ** 0.5)
    i = torch.arange(Sq, device=q.device)
    mask = (i[None, :] <= i[:, None])[None, None] & valid[:, None, None, :]
    s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bnij,bnjh->binh", p, v.float()).to(q.dtype)


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

    def project_qkv(self, x: torch.Tensor):
        """q (B, Sq, N, hd), k and v (B, Sq, Nkv, hd) of the normed input, on
        this rank's heads over a mesh (``parallel.tp.qkv``)."""
        B, Sq = x.shape[:2]
        hd = self.cfg.head_dim
        q, k, v = tp.qkv(self, x)
        return q.reshape(B, Sq, -1, hd), k.reshape(B, Sq, -1, hd), v.reshape(B, Sq, -1, hd)

    def forward(self, h, cos, sin, cache: Optional[dict], kv_valid, write_slot: WriteSlot,
                slots: Optional[torch.Tensor], l: int, ring=None) -> torch.Tensor:
        """qkv -> rope -> cache write at (l, write_slot) -> attention over the
        cache -> mlp.  ``slots`` is write_slot as a (B,) int32 tensor.
        ``cache=None``: attention over the chunk's own K/V, kv_valid's first
        Sq columns.  ``ring`` (a ``parallel.tp.Axis``): ``h`` is this rank's
        chunk of a prefill from slot 0 sharded over the ring; the chunks'
        K/V are gathered for the cache write and the attention is
        ``ring_attention`` over the chunk's own K/V (the JAX package's
        ``ring_axis``)."""
        x = self.input_norm(h)
        q, k, v = self.project_qkv(x)
        q, k = apply_rope(q, k, cos, sin)
        k, v = k.transpose(1, 2), v.transpose(1, 2)  # cache order (B, Nkv, Sq, hd)
        if cache is None:
            attn = chunk_causal_attention(q, k, v, kv_valid[:, :q.shape[1]])
            return self.out_mlp(h, attn)
        if ring is not None:
            ck, cv = (tp.gather_from_model(t, ring.group, ring.size, dim=2) for t in (k, v))
        else:
            ck, cv = k, v
        if "k_scale" in cache:  # int8 cache: K and V quantized per token and head, together
            (kq, vq), (ks, vs) = (t.unbind(0) for t in quantize_kv(torch.stack((ck, cv))))
            writes = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        else:
            writes = {"k": ck.to(cache["k"].dtype), "v": cv.to(cache["v"].dtype)}
        for name, chunk in writes.items():
            put_chunk(cache[name], chunk, l, write_slot)
        if ring is not None:
            Sq = q.shape[1]
            pos = (ring.rank * Sq + torch.arange(Sq, device=q.device))[None].expand(q.shape[0], Sq)
            attn = ring_attention(q, k.transpose(1, 2), v.transpose(1, 2), pos, pos,
                                  kv_valid[:, ring.rank * Sq:(ring.rank + 1) * Sq], ring)
            return self.out_mlp(h, attn)
        attn = cached_attention(q, cache["k"], cache["v"], kv_valid, slots,
                                k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"),
                                layer_index=l)
        return self.out_mlp(h, attn)

    def out_mlp(self, h, attn):
        """The output projection's residual, then the MLP's (over a mesh:
        ``parallel.tp``'s row-parallel sums)."""
        B, Sq = attn.shape[:2]
        h = h + tp.out_proj(self.o_proj, attn.reshape(B, Sq, -1), getattr(self, "heads", None))
        x2 = self.post_norm(h)
        return h + tp.mlp((self.gate_proj, self.up_proj), self.down_proj, x2,
                          lambda g, u: self.act(g) * u)


class Llama(nn.Module):
    """``quant``: the layers' weight tier, "none" (dense), "int8" or "int4";
    ``head_quant``: the tier of ``embed_tokens`` and ``lm_head`` ("none"
    keeps them in float over a quantized base; default: ``quant``)."""

    def __init__(self, cfg: LlamaConfig, *, device=None, dtype=None, quant: str = "none",
                 head_quant: Optional[str] = None):
        super().__init__()
        if cfg.attention_bias:
            raise NotImplementedError("attention_bias=true checkpoints are not supported")
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        head_quant = quant if head_quant is None else head_quant
        if head_quant not in ("none", quant):
            raise ValueError(f"head_quant {head_quant!r} must be 'none' or the layers' "
                             f"tier {quant!r}")
        if head_quant == "none":
            self.embed_tokens = nn.Parameter(
                torch.empty(cfg.vocab_size, cfg.hidden_size, **kw), requires_grad=False)
        else:
            self.embed_tokens = Int8Table(cfg.vocab_size, cfg.hidden_size, device=device)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, quant=quant, **kw)
            for _ in range(cfg.num_hidden_layers))
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)
        self.lm_head = make_linear(cfg.hidden_size, cfg.vocab_size, head_quant, **kw)
        # over a mesh (parallel.tp.attach): the kv heads a rank's cache holds,
        # its model axis, and whether the table holds its H-columns only
        self.kv_heads = cfg.num_key_value_heads
        self.tp = None
        self.embed_local = False

    def require(self, path: str) -> None:
        """Every path serves a LLaMA tower (``Jamba.require`` refuses some)."""

    def init_kv_cache(self, batch: int, max_len: int, dtype, *, device=None) -> dict:
        """``init_kv_cache`` of this tower's layers and kv heads."""
        return init_kv_cache(self.cfg, batch, max_len, dtype, device=device,
                             kv_heads=self.kv_heads)

    def pool_state(self, rows: int, dtype, *, device=None) -> dict:
        """What a paged pool keeps beside the K/V (``Jamba.pool_state``):
        nothing."""
        return {"rows": {}, "tallies": {}, "admit_counts": {}}

    def paged_decode(self, embeds, positions, state, attend, run=None) -> torch.Tensor:
        """Sq new tokens a row over a paged pool (embeds (B, Sq, H), rope
        positions (B, Sq)): in each layer ``attend(l, q, k, v)`` appends the
        new K/V to the pool and attends (B4; B5 to verify drafts).  ``state``
        and ``run`` go unread.  -> final-normed hidden (B, Sq, H)."""
        cos, sin = rope_table(positions, self.cfg.head_dim, self.cfg.rope_theta)
        h = embeds
        for l, layer in enumerate(self.layers):
            q, k, v = layer.project_qkv(layer.input_norm(h))  # over a mesh: the rank's heads
            q, k = apply_rope(q, k, cos, sin)
            h = layer.out_mlp(h, attend(l, q, k, v))
        return self.final_norm(h)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        """(B, S) ids -> (B, S, H) in the model's dtype (over a mesh, the
        rank's columns gathered)."""
        if isinstance(self.embed_tokens, Int8Table):
            e = self.embed_tokens(input_ids)
        else:
            e = F.embedding(input_ids, self.embed_tokens)
        return tp.whole(e, self.embed_local, self.tp).to(self.final_norm.weight.dtype)

    def forward(
        self,
        inputs_embeds: torch.Tensor,  # (B, Sq, H)
        rope_positions: torch.Tensor,  # (B, Sq) integer
        kv_cache: Optional[dict],  # see init_kv_cache; written in place
        kv_valid: torch.Tensor,  # (B, S) bool — valid AFTER this chunk is written
        write_slot: WriteSlot,  # cache slot of the chunk's first token
        remat: bool = False,  # recompute each layer in the backward
        ring=None,  # a parallel.tp.Axis: a context-parallel prefill from slot 0
    ) -> Tuple[torch.Tensor, Optional[dict]]:
        """Run the decoder stack: (final-normed hidden (B, Sq, H), kv_cache).
        ``kv_cache=None``: the cache-free training forward (the chunk from
        slot 0, kv_valid its (B, Sq) mask); it returns None for the cache.
        ``ring``: each rank of the ring runs its contiguous chunk of the
        prompt (Sq divisible by the ring's size), attends by
        ``ring_attention`` and writes the whole prompt's K/V; the hidden
        states are gathered at the end."""
        cfg = self.cfg
        B = inputs_embeds.shape[0]
        h = inputs_embeds
        if ring is not None:
            w = h.shape[1] // ring.size
            h = h[:, ring.rank * w:(ring.rank + 1) * w]
            rope_positions = rope_positions[:, ring.rank * w:(ring.rank + 1) * w]
        cos, sin = rope_table(rope_positions, cfg.head_dim, cfg.rope_theta)
        slots = (None if kv_cache is None
                 else slot_vector(write_slot, B, inputs_embeds.device))  # once, not per layer
        for l, layer in enumerate(self.layers):
            if remat:
                h = torch.utils.checkpoint.checkpoint(
                    fsdp.call, layer, h, cos, sin, kv_cache, kv_valid, write_slot, slots, l,
                    use_reentrant=False)
            else:
                h = fsdp.call(layer, h, cos, sin, kv_cache, kv_valid, write_slot, slots, l,
                              ring=ring)
        h = self.final_norm(h)
        if ring is not None:
            h = tp.gather_from_model(h, ring.group, ring.size, dim=1)
        return h, kv_cache

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """LM head, accumulated and returned in fp32 (dense, int8 or int4;
        over a mesh, the rank's vocabulary columns gathered)."""
        y, local = tp.linear(self.lm_head, hidden, f32=True)
        return tp.whole(y, local, self.tp)

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
