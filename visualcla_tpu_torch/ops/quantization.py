"""Weight-only int8/int4 quantization and the int8 KV cache (port of
visualcla_tpu/ops/quantization.py).

Formats, as in the JAX package (the same bytes):
- **int8 per output channel**: W (in, out) ~ q * scale with q int8 and scale
  = absmax / 127 over the contraction axis, f32, keeping the reduced axis
  ((1, out) for a matmul leaf, (V, 1) for the per-row embedding table);
- **int4 grouped, v2 carrier**: W (in, out) split into G = in / gs groups
  along the contraction; q is a uint8 carrier (G, gs/2, out) whose byte
  [g, r, o] holds W4[g, r, o] in the low nibble and W4[g, r + gs/2, o] in the
  high nibble (signed, range +-7), scale f32 (G, out) = absmax / 7 per group;
- **int8 KV**: per token and head, x (..., hd) -> int8 and an f32 scale (...).

A zero absmax gives scale 1.  Division is in f32 and rounding is half to
even (``np.rint`` / ``torch.round``), so the numpy and torch versions here
and the JAX package's produce identical bytes.

The host (numpy) functions quantize a checkpoint while it streams, so the
bf16 original of a quantized leaf never reaches the card; the torch
functions quantize tensors where they lie (``quantize_text_tower_`` on a
model made on the card) and the KV cache inside the decoder.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# text-tower leaves that quantize, keyed by flat path -> contraction axis
INT8_TEXT_LEAVES = {
    "text/layers/q_proj": -2, "text/layers/k_proj": -2, "text/layers/v_proj": -2,
    "text/layers/o_proj": -2, "text/layers/gate_proj": -2,
    "text/layers/up_proj": -2, "text/layers/down_proj": -2,
    "text/embed_tokens": -1, "text/lm_head": -2,
}


INT4_GROUP = 128  # the int4 tier's group size where it divides (the JAX default)


def effective_group(in_dim: int, group: int = INT4_GROUP) -> Optional[int]:
    """The requested group when it divides ``in_dim``, else the largest power
    of two below it that does; None when no divisor >= 8 exists (that leaf
    then falls back to per-channel int8)."""
    g = group
    if in_dim % g == 0:
        return g
    while g >= 8:
        if in_dim % g == 0:
            return g
        g //= 2
    return None


# ---------------------------------------------------------------------------
# host side (numpy)
# ---------------------------------------------------------------------------

def quantize_np(w: np.ndarray, axis: int = -2) -> dict:
    """Per-channel symmetric int8 along ``axis`` (negative, so it holds under
    slicing): {"q": int8, "scale": f32 with ``axis`` kept}.  Stacked (>= 3-d)
    leaves go one leading-axis slice at a time."""
    w = np.asarray(w)
    if axis >= 0:
        axis -= w.ndim
    if w.ndim >= 3:
        parts = [quantize_np(w[i], axis=axis) for i in range(w.shape[0])]
        return {"q": np.stack([p["q"] for p in parts]),
                "scale": np.stack([p["scale"] for p in parts])}
    wf = w.astype(np.float32)
    scale = np.max(np.abs(wf), axis=axis, keepdims=True) / np.float32(127.0)
    scale[scale == 0] = 1.0
    np.divide(wf, scale, out=wf)
    np.rint(wf, out=wf)
    np.clip(wf, -127, 127, out=wf)
    return {"q": wf.astype(np.int8), "scale": scale.astype(np.float32)}


def pack_s4_rows(q):
    """Signed 4-bit values (int8 in [-8, 7], (..., G, gs, out), gs even) ->
    the v2 uint8 carrier (..., G, gs/2, out): row r -> low nibble, row
    r + gs/2 -> high nibble.  numpy arrays or torch tensors."""
    gs = q.shape[-2]
    if gs % 2:
        raise ValueError(f"pack_s4_rows needs an even group size, got {tuple(q.shape)}")
    gsh = gs // 2
    if isinstance(q, torch.Tensor):
        b = q.to(torch.int32)
        return ((b[..., :gsh, :] & 0xF) | ((b[..., gsh:, :] & 0xF) << 4)).to(torch.uint8)
    b = np.asarray(q).astype(np.int32)
    return ((b[..., :gsh, :] & 0xF) | ((b[..., gsh:, :] & 0xF) << 4)).astype(np.uint8)


def unpack_s4_halves(packed):
    """v2 carrier (..., G, gs/2, out) -> (lo, hi) signed halves, each
    (..., G, gs/2, out) int8: rows [0, gs/2) and [gs/2, gs) of each group."""
    if isinstance(packed, torch.Tensor):
        b = packed.to(torch.int32)
        return ((b << 28) >> 28).to(torch.int8), ((b << 24) >> 28).to(torch.int8)
    b = np.asarray(packed).astype(np.int32)
    return ((b << 28) >> 28).astype(np.int8), ((b << 24) >> 28).astype(np.int8)


def unpack_s4_rows(packed):
    """Inverse of :func:`pack_s4_rows`: (..., G, gs/2, out) -> (..., G, gs, out) int8."""
    lo, hi = unpack_s4_halves(packed)
    if isinstance(packed, torch.Tensor):
        return torch.cat([lo, hi], dim=-2)
    return np.concatenate([lo, hi], axis=-2)


def _check_group(in_dim: int, group: int) -> None:
    if in_dim % group:
        raise ValueError(f"contraction dim {in_dim} not divisible by group {group}")
    if group % 2:
        raise ValueError(f"int4 needs an even group size, got {group}")


def quantize_grouped_np(w: np.ndarray, group: int = 128) -> dict:
    """Group-wise symmetric int4 along the contraction (second to last) axis:
    W (..., in, out) -> {"q": (..., G, gs/2, out) uint8 carrier, "scale":
    (..., G, out) f32}.  Stacked leaves go one leading-axis slice at a time."""
    w = np.asarray(w)
    in_dim = w.shape[-2]
    _check_group(in_dim, group)
    if w.ndim >= 3:
        parts = [quantize_grouped_np(w[i], group=group) for i in range(w.shape[0])]
        return {"q": np.stack([p["q"] for p in parts]),
                "scale": np.stack([p["scale"] for p in parts])}
    wg = w.astype(np.float32).reshape(in_dim // group, group, w.shape[-1])
    scale = np.max(np.abs(wg), axis=-2, keepdims=True) / np.float32(7)
    scale[scale == 0] = 1.0
    np.divide(wg, scale, out=wg)
    np.rint(wg, out=wg)
    np.clip(wg, -7, 7, out=wg)
    return {"q": pack_s4_rows(wg.astype(np.int8)), "scale": scale[..., 0, :].astype(np.float32)}


# ---------------------------------------------------------------------------
# device side (torch), bitwise equal to the numpy versions
# ---------------------------------------------------------------------------

def quantize(w: torch.Tensor, axis: int = -2) -> dict:
    """Per-channel symmetric int8 of a tensor, where it lies: {"q", "scale"}
    as :func:`quantize_np`."""
    wf = w.float()
    scale = wf.abs().amax(dim=axis, keepdim=True) / 127.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.round(wf / scale).clamp_(-127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def quantize_grouped(w: torch.Tensor, group: int = 128) -> dict:
    """Group-wise int4 of an (in, out) tensor, where it lies: {"q", "scale"}
    as :func:`quantize_grouped_np`."""
    in_dim, out = w.shape[-2], w.shape[-1]
    _check_group(in_dim, group)
    wg = w.float().reshape(*w.shape[:-2], in_dim // group, group, out)
    scale = wg.abs().amax(dim=-2, keepdim=True) / 7.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = pack_s4_rows(torch.round(wg / scale).clamp_(-7, 7).to(torch.int8))
    # contiguous whatever w's strides (a transposed weight gives a strided wg)
    return {"q": q.contiguous(), "scale": scale[..., 0, :].contiguous()}


def dequantize_grouped(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Grouped int4 weight {q (..., G, gs/2, out), scale (..., G, out)} -> the
    dense (..., in, out) weight: f32 dequant, then one rounding to ``dtype``."""
    w = unpack_s4_rows(q).float() * scale[..., None, :]
    return w.reshape(*w.shape[:-3], w.shape[-3] * w.shape[-2], w.shape[-1]).to(dtype)


def quantize_kv(x: torch.Tensor):
    """Per-token-per-head int8 for the KV cache: x (..., hd) -> (int8 of the
    same shape, f32 scales (...)).

    The same bits as the JAX package's in fewer launches (the decode step
    runs it in every layer, and each launch costs host time): the absmax is
    exact at any precision, the division promotes to f32 without a copy of
    x, and no clip is needed because |x / s| <= 127 by construction."""
    absmax = torch.linalg.vector_norm(x, ord=float("inf"), dim=-1, dtype=torch.float32)
    s = (absmax / 127.0).masked_fill_(absmax == 0, 1.0)
    return (x / s[..., None]).round_().to(torch.int8), s


def q_take(w, ids: torch.Tensor) -> torch.Tensor:
    """Row gather from a table: a dense tensor, or a per-row int8 table
    {"q": (V, H) int8, "scale": (V, 1) f32} dequantized to f32."""
    if not isinstance(w, dict):
        return w[ids]
    return w["q"][ids].float() * w["scale"][ids]
