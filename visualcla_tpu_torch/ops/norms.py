"""Normalization ops (port of visualcla_tpu/ops/norms.py).

- RMSNorm: HF LlamaRMSNorm — statistics in fp32, scale in the input dtype.
- LayerNorm: torch.nn.LayerNorm semantics with statistics in at least fp32.
"""
from __future__ import annotations

import torch
from torch import nn


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """LLaMA RMSNorm over the last axis.  x: (..., H), weight: (H,)."""
    dtype = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    # HF casts back to the input dtype before the weight multiply
    return (weight * xf.to(dtype)).to(dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm over the last axis, statistics in promote(dtype, fp32)."""
    dtype = x.dtype
    xf = x.to(torch.promote_types(dtype, torch.float32))
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * weight.to(xf.dtype) + bias.to(xf.dtype)
    return y.to(dtype)


class RMSNorm(nn.Module):
    """Holds an RMSNorm weight (ones at construction)."""

    def __init__(self, hidden: int, eps: float, *, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(hidden, device=device, dtype=dtype),
                                   requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)


class LayerNorm(nn.Module):
    """Holds a LayerNorm weight and bias (ones and zeros at construction)."""

    def __init__(self, hidden: int, eps: float, *, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(hidden, device=device, dtype=dtype),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(hidden, device=device, dtype=dtype),
                                 requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)
