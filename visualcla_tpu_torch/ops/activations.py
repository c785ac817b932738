"""Activation functions (port of visualcla_tpu/ops/activations.py).

- quick_gelu: CLIP's x * sigmoid(1.702 x);
- gelu_exact: exact erf GELU (the resampler's ``hidden_act``; ``gelu`` is it);
- gelu_tanh: the tanh approximation (HF's ``gelu_new`` / ``gelu_pytorch_tanh``);
- silu: x * sigmoid(x) (the LLaMA MLP).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


gelu = gelu_exact


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


ACT2FN = {
    "quick_gelu": quick_gelu,
    "gelu": gelu_exact,
    "gelu_new": gelu_tanh,
    "gelu_pytorch_tanh": gelu_tanh,
    "silu": silu,
    "relu": torch.relu,
    "tanh": torch.tanh,
}
