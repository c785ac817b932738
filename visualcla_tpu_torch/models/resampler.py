"""Visual resampler: learnable queries cross-attending over image tokens (port
of visualcla_tpu/models/resampler.py).

Each layer's K/V run over ``[queries ; image tokens]``, the softmax runs in
the input dtype ("native"), pruned heads are zeroed by ``head_mask`` (set by
``prune_heads`` or a checkpoint's ``head_mask`` leaf), and the blocks are
post-LN with an exact-gelu FFN.  ``pool`` is the pooler, unused by the chat.
"""
from __future__ import annotations

import torch
from torch import nn

from ..core.config import ResamplerConfig

from ..ops.activations import ACT2FN
from ..ops.attention import full_attention
from ..ops.linear import Linear
from ..ops.norms import LayerNorm


class ResamplerLayer(nn.Module):
    def __init__(self, cfg: ResamplerConfig, *, device=None, dtype=None):
        super().__init__()
        H, I = cfg.hidden_size, cfg.intermediate_size
        kw = dict(device=device, dtype=dtype)
        self.num_heads, self.head_dim = cfg.num_attention_heads, cfg.head_dim
        self.act = ACT2FN[cfg.hidden_act]
        self.q_proj = Linear(H, H, True, **kw)
        self.k_proj = Linear(H, H, True, **kw)
        self.v_proj = Linear(H, H, True, **kw)
        self.attn_out = Linear(H, H, True, **kw)
        self.attn_ln = LayerNorm(H, cfg.layer_norm_eps, **kw)
        self.inter = Linear(H, I, True, **kw)
        self.out = Linear(I, H, True, **kw)
        self.out_ln = LayerNorm(H, cfg.layer_norm_eps, **kw)

    def forward(self, h: torch.Tensor, image_embeds: torch.Tensor,
                head_mask: torch.Tensor) -> torch.Tensor:
        B, Nq, H = h.shape
        N, hd = self.num_heads, self.head_dim
        kv_in = torch.cat([h, image_embeds], dim=1)  # (B, Nq + S_img, H)
        Skv = kv_in.shape[1]
        q = self.q_proj(h).reshape(B, Nq, N, hd)
        k = self.k_proj(kv_in).reshape(B, Skv, N, hd)
        v = self.v_proj(kv_in).reshape(B, Skv, N, hd)
        ctx = full_attention(q, k, v, softmax_dtype="native")
        ctx = (ctx * head_mask[None, None, :, None].to(ctx.dtype)).reshape(B, Nq, H)
        attn_out = self.attn_ln(self.attn_out(ctx) + h)
        ffn = self.out(self.act(self.inter(attn_out)))
        return self.out_ln(ffn + attn_out)


class Resampler(nn.Module):
    def __init__(self, cfg: ResamplerConfig, *, device=None, dtype=None):
        super().__init__()
        H, L = cfg.hidden_size, cfg.num_hidden_layers
        kw = dict(device=device, dtype=dtype)
        self.query_embedding = nn.Parameter(
            torch.zeros(cfg.num_query_tokens, H, **kw), requires_grad=False)
        self.layers = nn.ModuleList(ResamplerLayer(cfg, **kw) for _ in range(L))
        self.register_buffer(
            "head_mask", torch.ones(L, cfg.num_attention_heads, **kw))
        # the pooler is part of the checkpoint but unused by the chat path
        self.pooler = Linear(H, H, True, **kw) if cfg.add_pooling_layer else None

    def forward(self, image_embeds: torch.Tensor) -> torch.Tensor:
        """(B, S_img, H) image tokens -> (B, num_query_tokens, H)."""
        B = image_embeds.shape[0]
        h = self.query_embedding[None].expand(B, -1, -1).to(image_embeds.dtype)
        for layer, mask in zip(self.layers, self.head_mask):
            h = layer(h, image_embeds, mask)
        return h


@torch.no_grad()
def prune_heads(resampler: Resampler, heads_to_prune: dict) -> Resampler:
    """The reference's ``prune_heads`` surface, ``{layer: [head, ...]}``, in
    place: a pruned head's row of ``head_mask`` is zeroed, which zeroes its
    context exactly as slicing the head out of q/k/v and the output
    projection would."""
    L, N = resampler.head_mask.shape
    for l, heads in heads_to_prune.items():  # every index checked before any is pruned
        if not 0 <= l < L:
            raise ValueError(f"layer {l} out of range (0..{L - 1})")
        for h in heads:
            if not 0 <= h < N:
                raise ValueError(f"head {h} out of range (0..{N - 1})")
    for l, heads in heads_to_prune.items():
        resampler.head_mask[l, list(heads)] = 0.0
    return resampler


def pool(resampler: Resampler, hidden: torch.Tensor) -> torch.Tensor:
    """Pooler: tanh(dense(first token)).  Part of the model surface, unused
    by the chat pipeline."""
    return torch.tanh(resampler.pooler(hidden[:, 0]))
