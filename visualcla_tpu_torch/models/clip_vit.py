"""CLIP ViT-L/14 vision tower (port of visualcla_tpu/models/clip_vit.py).

Pre-LN residual blocks, quick-gelu MLP, dense fp32-softmax attention, and
``post_layernorm`` applied to the FULL last hidden state (CLS included), as
the VisualCLA pipeline does.  The 14x14 stride-14 patch convolution is a
reshape plus a matmul over Conv2d's channel-major patch order.
``extend_position_embedding`` is not ported yet.
"""
from __future__ import annotations

import torch
from torch import nn

from ..core.config import ViTConfig

from ..ops.activations import ACT2FN
from ..ops.attention import full_attention
from ..ops.linear import Linear
from ..ops.norms import LayerNorm


def patchify(pixel_values: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, 3, H, W) -> (B, num_patches, 3*P*P) in torch Conv2d's (C, P, P)
    flattening order."""
    B, C, H, W = pixel_values.shape
    P = patch_size
    gh, gw = H // P, W // P
    x = pixel_values.reshape(B, C, gh, P, gw, P).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(B, gh * gw, C * P * P)


class ViTLayer(nn.Module):
    def __init__(self, cfg: ViTConfig, *, device=None, dtype=None):
        super().__init__()
        H, I = cfg.hidden_size, cfg.intermediate_size
        kw = dict(device=device, dtype=dtype)
        self.num_heads, self.head_dim = cfg.num_attention_heads, cfg.head_dim
        self.act = ACT2FN[cfg.hidden_act]
        self.ln1 = LayerNorm(H, cfg.layer_norm_eps, **kw)
        self.q_proj = Linear(H, H, True, **kw)
        self.k_proj = Linear(H, H, True, **kw)
        self.v_proj = Linear(H, H, True, **kw)
        self.o_proj = Linear(H, H, True, **kw)
        self.ln2 = LayerNorm(H, cfg.layer_norm_eps, **kw)
        self.fc1 = Linear(H, I, True, **kw)
        self.fc2 = Linear(I, H, True, **kw)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        B, S, _ = h.shape
        N, hd = self.num_heads, self.head_dim
        y = self.ln1(h)
        q = self.q_proj(y).reshape(B, S, N, hd)
        k = self.k_proj(y).reshape(B, S, N, hd)
        v = self.v_proj(y).reshape(B, S, N, hd)
        attn = full_attention(q, k, v)  # bidirectional, no mask
        h = h + self.o_proj(attn.reshape(B, S, N * hd))
        y = self.ln2(h)
        return h + self.fc2(self.act(self.fc1(y)))


class CLIPVisionTower(nn.Module):
    def __init__(self, cfg: ViTConfig, *, device=None, dtype=None):
        super().__init__()
        H, P = cfg.hidden_size, cfg.patch_size
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.class_embedding = nn.Parameter(torch.zeros(H, **kw), requires_grad=False)
        self.patch_embedding = Linear(3 * P * P, H, False, **kw)
        self.position_embedding = nn.Parameter(torch.empty(cfg.seq_len, H, **kw),
                                               requires_grad=False)
        self.pre_layernorm = LayerNorm(H, cfg.layer_norm_eps, **kw)
        self.layers = nn.ModuleList(
            ViTLayer(cfg, **kw) for _ in range(cfg.num_hidden_layers))
        self.post_layernorm = LayerNorm(H, cfg.layer_norm_eps, **kw)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """(B, 3, 224, 224) -> (B, 257, H), post-LN over the full sequence."""
        B = pixel_values.shape[0]
        H = self.cfg.hidden_size
        patches = patchify(pixel_values, self.cfg.patch_size).to(
            self.patch_embedding.weight.dtype)
        cls = self.class_embedding[None, None, :].expand(B, 1, H)
        x = torch.cat([cls, self.patch_embedding(patches)], dim=1)
        x = self.pre_layernorm(x + self.position_embedding[None])
        for layer in self.layers:
            x = layer(x)
        return self.post_layernorm(x)
