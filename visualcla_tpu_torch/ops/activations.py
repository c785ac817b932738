"""Activation functions (port of visualcla_tpu/ops/activations.py).

- quick_gelu: CLIP's x * sigmoid(1.702 x);
- gelu: exact erf GELU (the resampler's ``hidden_act``);
- silu: x * sigmoid(x) (the LLaMA MLP).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


ACT2FN = {"quick_gelu": quick_gelu, "gelu": gelu, "silu": silu}
