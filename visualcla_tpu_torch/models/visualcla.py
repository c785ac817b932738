"""Composite VisualCLA model: CLIP-ViT -> resampler -> projection -> LLaMA
splice (port of visualcla_tpu/models/visualcla.py).

The prompt reserves ``num_image_tokens`` ``<img_token>`` placeholders after
each ``<img>`` marker; the splice overwrites their embeddings with the
projected image embeddings, so the sequence length never changes.  Marker
positions are host values (numpy), known before the device work starts, or
device tensors (a captured prefill reads them from a static buffer).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..core.config import VisualCLAConfig

from ..ops.linear import Int8Table, Linear, quantize_linear
from .clip_vit import CLIPVisionTower
from .llama import Llama
from .resampler import Resampler


class VisionTowers(nn.Module):
    """The vision side alone (ViT, resampler, projection), dense, built
    directly on ``device`` in ``dtype``: what ``encode_image`` reads."""

    def __init__(self, cfg: VisualCLAConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.vision = CLIPVisionTower(cfg.vision_config, **kw)
        self.resampler = (Resampler(cfg.visual_resampler_config, **kw)
                          if cfg.use_visual_resampler else None)
        self.projection = Linear(cfg.vision_config.hidden_size,
                                 cfg.text_config.hidden_size, True, **kw)


class VisualCLAModel(VisionTowers):
    """All weights of the model, built directly on ``device`` in ``dtype``.
    Matrices start uninitialised: load a checkpoint or call ``init_random_``.
    ``quant`` ("none", "int8", "int4") is the text tower's weight tier; the
    ViT, resampler and projection stay dense, as in the JAX package."""

    def __init__(self, cfg: VisualCLAConfig, *, device=None, dtype=None, quant: str = "none"):
        super().__init__(cfg, device=device, dtype=dtype)
        self.text = Llama(cfg.text_config, quant=quant, device=device, dtype=dtype)


@torch.no_grad()
def quantize_text_tower_(model: VisualCLAModel, bits: int) -> VisualCLAModel:
    """Quantize the text tower of a dense model in place, where its weights
    lie: every layer matmul and the LM head to int8 (``bits=8``) or grouped
    int4 (``bits=4``, group ``effective_group(in)``), the embedding
    table to per-row int8.  Each dense original is dropped as soon as its
    quantized form exists, so the peak is one weight above the result."""
    quant = {8: "int8", 4: "int4"}.get(bits)
    if quant is None:
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    text = model.text
    if not isinstance(text.lm_head, Linear):
        raise ValueError("the text tower is quantized already")
    for layer in text.layers:
        for name in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
                     "down_proj"):
            setattr(layer, name, quantize_linear(getattr(layer, name), quant))
    text.lm_head = quantize_linear(text.lm_head, quant)
    table = text.embed_tokens
    del text.embed_tokens  # the Parameter: the attribute becomes a module
    text.embed_tokens = Int8Table.from_dense(table)
    return model


@torch.no_grad()
def init_random_(model: nn.Module, generator: torch.Generator,
                 std: float = 0.02) -> nn.Module:
    """Seeded random weights, drawn in place on the model's device: every
    matrix and the ViT class embedding ~ N(0, std^2); norm weights stay one,
    biases and the head mask as built."""
    for name, p in model.named_parameters():
        if p.dim() >= 2 or name.endswith("class_embedding"):
            p.normal_(0.0, std, generator=generator)
    return model


def encode_image(model: VisionTowers, cfg: VisualCLAConfig,
                 pixel_values: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) pixels -> (B, num_image_tokens, text_hidden): ViT (full
    sequence post-LN) -> resampler -> projection."""
    image_embeds = model.vision(pixel_values)
    if cfg.use_visual_resampler:
        image_embeds = model.resampler(image_embeds)
    return model.projection(image_embeds)


def check_img_start_pos(img_start_pos, num_image_tokens: int, seq_len: int) -> None:
    """Raise if a marker leaves no room for its image tokens in the prompt."""
    ip = np.asarray(img_start_pos)
    if np.any((ip >= 0) & (ip + 1 + num_image_tokens > seq_len)):
        raise ValueError(
            f"image marker at {ip.tolist()} leaves no room for "
            f"{num_image_tokens} image tokens in a {seq_len}-slot prompt")


def splice_image_embeds(inputs_embeds: torch.Tensor, image_embeds: torch.Tensor,
                        img_start_pos) -> torch.Tensor:
    """Overwrite the T embeddings after each row's ``<img>`` (-1 = text-only
    row) with that row's (T, H) image embeddings.  The positions are host
    values, or a (B,) integer tensor on the embeddings' device: then the
    splice is one gather and one scatter, with no read back to the host (a
    captured prefill's form)."""
    if isinstance(img_start_pos, torch.Tensor):
        return _splice_on_device(inputs_embeds, image_embeds, img_start_pos.reshape(-1))
    out = inputs_embeds.clone()
    T = image_embeds.shape[1]
    for b, pos in enumerate(np.asarray(img_start_pos).reshape(-1).tolist()):
        if pos >= 0:
            out[b, pos + 1:pos + 1 + T] = image_embeds[b].to(out.dtype)
    return out


def _splice_on_device(embeds: torch.Tensor, image_embeds: torch.Tensor,
                      pos: torch.Tensor) -> torch.Tensor:
    """``splice_image_embeds`` at device positions (B,): a row without an
    image writes its own embeddings back."""
    B, S, H = embeds.shape
    T = image_embeds.shape[1]
    idx = ((pos.clamp(min=0) + 1)[:, None] + torch.arange(T, device=embeds.device)[None, :])
    idx = idx.clamp(max=S - 1)[..., None].expand(B, T, H)
    new = torch.where((pos >= 0)[:, None, None], image_embeds.to(embeds.dtype),
                      embeds.gather(1, idx))
    return embeds.scatter(1, idx, new)


def multimodal_embeds(
    model: VisualCLAModel,
    cfg: VisualCLAConfig,
    input_ids: torch.Tensor,  # (B, S)
    img_start_pos,  # (B,) or (B, K) ints, host or device; -1 = no image
    pixel_values: Optional[torch.Tensor],  # (B, 3, H, W) | (B, K, 3, H, W) | None
) -> torch.Tensor:
    """Token embeddings with the image embeddings spliced in."""
    embeds = model.text.embed(input_ids)
    if pixel_values is None:
        return embeds
    if pixel_values.dim() == 5:  # multi-image: one marker per image
        B, K = pixel_values.shape[:2]
        flat = encode_image(model, cfg, pixel_values.reshape((B * K,) + pixel_values.shape[2:]))
        image_embeds = flat.reshape((B, K) + flat.shape[1:])
        pos = (img_start_pos.reshape(B, K) if isinstance(img_start_pos, torch.Tensor)
               else np.asarray(img_start_pos).reshape(B, K))
        for k in range(K):
            embeds = splice_image_embeds(embeds, image_embeds[:, k], pos[:, k])
        return embeds
    return splice_image_embeds(embeds, encode_image(model, cfg, pixel_values),
                               img_start_pos)


def find_img_start(input_ids, img_start_token_id: int) -> torch.Tensor:
    """First position of ``<img>`` per row, or -1.  (B, S) -> (B,) int32."""
    hit = torch.as_tensor(input_ids) == img_start_token_id
    pos = hit.int().argmax(dim=-1).to(torch.int32)
    return torch.where(hit.any(dim=-1), pos, torch.full_like(pos, -1))
