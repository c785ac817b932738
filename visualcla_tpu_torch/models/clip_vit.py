"""CLIP ViT-L/14 vision tower (port of visualcla_tpu/models/clip_vit.py).

Pre-LN residual blocks, quick-gelu MLP, fp32-softmax attention (dense, or
kernel B2u with ``VISUALCLA_VIT_ATTN=flash``), and ``post_layernorm``
applied to the FULL last hidden state (CLS included), as the VisualCLA
pipeline does.  The 14x14 stride-14 patch convolution is a reshape plus a
matmul over Conv2d's channel-major patch order.  ``extend_position_embedding``
resizes the position table for a larger input resolution.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..core.config import ViTConfig

from ..ops.activations import ACT2FN
from ..ops.attention import full_attention
from ..ops.linear import Linear
from ..ops.norms import LayerNorm


def _torch_bicubic_1d(in_size: int, out_size: int) -> torch.Tensor:
    """(out, in) float32 interpolation matrix of torch.nn.functional.interpolate
    mode='bicubic' (a=-0.75, align_corners=False, no antialias)."""
    a = -0.75

    def w(x):
        x = abs(x)
        if x < 1.0:
            return ((a + 2) * x - (a + 3)) * x * x + 1
        if x < 2.0:
            return (((x - 5) * x + 8) * x - 4) * a
        return 0.0

    scale = in_size / out_size
    M = np.zeros((out_size, in_size), np.float64)
    for i in range(out_size):
        src = (i + 0.5) * scale - 0.5
        x0 = int(np.floor(src))
        t = src - x0
        for off in range(-1, 3):
            j = min(max(x0 + off, 0), in_size - 1)
            M[i, j] += w(off - t)
    return torch.from_numpy(M.astype(np.float32))


@torch.no_grad()
def extend_position_embedding(tower: "CLIPVisionTower", after: int) -> "CLIPVisionTower":
    """Bicubic-resize the tower's position table, in place, for ``after``-pixel
    inputs (the JAX package's ``extend_position_embedding``): the CLS row
    passes through, the (g, g) patch grid is resized to (after / patch)^2
    rows in fp32 and cast back to the table's dtype."""
    pe = tower.position_embedding
    n_before, H = pe.shape
    grid_before = int((n_before - 1) ** 0.5)
    grid_after = after // tower.cfg.patch_size
    M = _torch_bicubic_1d(grid_before, grid_after).to(pe.device)
    g = pe[1:].reshape(grid_before, grid_before, H).float()
    g = torch.einsum("oi,ijh->ojh", M, g)
    g = torch.einsum("oj,ijh->ioh", M, g)
    new_pe = torch.cat([pe[:1], g.reshape(grid_after * grid_after, H).to(pe.dtype)], dim=0)
    tower.position_embedding = nn.Parameter(new_pe, requires_grad=False)
    tower.cfg = dataclasses.replace(tower.cfg, image_size=after)
    return tower


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
