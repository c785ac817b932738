"""Dense linear layer (port of the dense leaf of visualcla_tpu/ops/linear.py).

Weights are stored as torch's ``(out, in)``; the checkpoint converter
transposes the JAX package's ``(in, out)`` leaves.  The int8, int4 and LoRA
leaves are not ported yet (ROADMAP, open item 1 "Quantized tiers").
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Linear(nn.Module):
    """``y = x W^T (+ b)`` with an uninitialised weight built directly on
    ``device`` in ``dtype`` (weights come from a checkpoint or from
    ``models.visualcla.init_random_``); the bias starts at zero."""

    def __init__(self, in_features: int, out_features: int, bias: bool, *,
                 device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features, device=device, dtype=dtype),
            requires_grad=False)
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device, dtype=dtype),
                                  requires_grad=False) if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)
