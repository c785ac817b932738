"""Rotary position embeddings, HF-Llama split-half convention (port of
visualcla_tpu/ops/rope.py): fp32 tables, cast to the activation dtype before
the multiply."""
from __future__ import annotations

import torch


def rope_table(positions: torch.Tensor, head_dim: int,
               theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) integer -> cos, sin (..., S, head_dim) fp32."""
    inv_freq = 1.0 / (theta ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device)
        / head_dim))
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """q (B, S, N, hd), k (B, S, Nkv, hd), cos/sin (B, S, hd) or (S, hd)."""
    cos = cos.to(q.dtype)[..., None, :]
    sin = sin.to(q.dtype)[..., None, :]
    q_out = q * cos + _rotate_half(q) * sin
    k_out = k * cos.to(k.dtype) + _rotate_half(k) * sin.to(k.dtype)
    return q_out, k_out
