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
from ..parallel import tp
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
    ``quant`` ("none", "int8", "int4") is the text tower's weight tier and
    ``head_quant`` that of its embedding and LM head (``Llama``); the ViT,
    resampler and projection stay dense, as in the JAX package."""

    def __init__(self, cfg: VisualCLAConfig, *, device=None, dtype=None, quant: str = "none",
                 head_quant: Optional[str] = None):
        super().__init__(cfg, device=device, dtype=dtype)
        self.text = Llama(cfg.text_config, quant=quant, head_quant=head_quant, device=device,
                          dtype=dtype)


@torch.no_grad()
def quantize_text_tower_(model: VisualCLAModel, bits: int, head: bool = True) -> VisualCLAModel:
    """Quantize the text tower of a dense model in place, where its weights
    lie: every layer matmul and the LM head to int8 (``bits=8``) or grouped
    int4 (``bits=4``, group ``effective_group(in)``), the embedding
    table to per-row int8.  ``head=False`` keeps the embedding table and the
    LM head in float (the QLoRA tree: they train).  Each dense original is
    dropped as soon as its quantized form exists, so the peak is one weight
    above the result."""
    quant = {8: "int8", 4: "int4"}.get(bits)
    if quant is None:
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    text = model.text
    if not isinstance(text.layers[0].q_proj, Linear):
        raise ValueError("the text tower is quantized already")
    for layer in text.layers:
        for name in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
                     "down_proj"):
            setattr(layer, name, quantize_linear(getattr(layer, name), quant))
    if not head:
        return model
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


@torch.no_grad()
def resize_token_embeddings(model: VisualCLAModel, new_size: int,
                            generator: Optional[torch.Generator] = None,
                            initializer_range: float = 0.02) -> VisualCLAModel:
    """Grow (or truncate) the text tower's vocabulary in place: the rows of
    ``text.embed_tokens`` and of ``text.lm_head``'s (V, H) weight, the
    reference's ``resize_token_embeddings`` before a LoRA adapter loads
    (scripts/inference/inference.py:66-74).  New rows are drawn N(0,
    ``initializer_range``) in fp32 from ``generator`` (default: a CPU
    generator seeded 0), the embedding's first and then the head's, and cast
    to each leaf's dtype on its device; kept rows are untouched.

    After the call the forward reads the vocabulary size from the modules'
    widths (the embedding's rows, the head's outputs).  ``cfg.text_config.
    vocab_size`` is left as it was, as the JAX function, which returns a new
    tree, leaves the config to its caller: replace it before writing a
    checkpoint.  Float leaves only, as the JAX function: an int8 embedding
    table or a quantized or LoRA head raises a ValueError naming its tier.
    A model sharded over a mesh raises too: each rank holds a slice of the
    head's rows and of the embedding's columns, so resize before
    ``shard_params``."""
    text = model.text
    if getattr(model, "mesh", None) is not None or text.tp is not None:
        raise ValueError("resize_token_embeddings: the model is sharded over a mesh; resize "
                         "it before shard_params (each rank holds a slice of the vocabulary)")
    if isinstance(text.embed_tokens, Int8Table):
        raise ValueError("resize_token_embeddings: the embedding table is at the int8 tier "
                         "(Int8Table); only float tables resize")
    if type(text.lm_head) is not Linear:
        tier = {"Int8Linear": "int8", "Int4Linear": "int4", "LoraLinear": "LoRA"}.get(
            type(text.lm_head).__name__, type(text.lm_head).__name__)
        raise ValueError(f"resize_token_embeddings: the LM head is at the {tier} tier "
                         f"({type(text.lm_head).__name__}); only a float head resizes")
    if new_size <= 0:
        raise ValueError(f"new_size must be positive, got {new_size}")
    if generator is None:
        generator = torch.Generator().manual_seed(0)

    def resized(w: torch.Tensor) -> nn.Parameter:
        old = w.shape[0]
        if new_size <= old:
            data = w[:new_size].clone()
        else:
            extra = torch.randn((new_size - old,) + tuple(w.shape[1:]), generator=generator,
                                dtype=torch.float32, device=generator.device)
            extra = (extra * initializer_range).to(device=w.device, dtype=w.dtype)
            data = torch.cat([w, extra], dim=0)
        return nn.Parameter(data, requires_grad=w.requires_grad)

    text.embed_tokens = resized(text.embed_tokens)
    text.lm_head.weight = resized(text.lm_head.weight)
    return model


def encode_image(model: VisionTowers, cfg: VisualCLAConfig,
                 pixel_values: torch.Tensor, remat: bool = False) -> torch.Tensor:
    """(B, 3, H, W) pixels -> (B, num_image_tokens, text_hidden): ViT (full
    sequence post-LN) -> resampler -> projection; ``remat`` recomputes each
    tower's layers in the backward."""
    image_embeds = model.vision(pixel_values, remat=remat)
    if cfg.use_visual_resampler:
        image_embeds = model.resampler(image_embeds, remat=remat)
    y, local = tp.linear(model.projection, image_embeds)  # over a mesh: gathered
    return tp.whole(y, local, getattr(model.projection, "tp", None))


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
    captured prefill's form).  Both forms are differentiable in both
    embeddings."""
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
    remat: bool = False,
) -> torch.Tensor:
    """Token embeddings with the image embeddings spliced in."""
    embeds = model.text.embed(input_ids)
    if pixel_values is None:
        return embeds
    if pixel_values.dim() == 5:  # multi-image: one marker per image
        B, K = pixel_values.shape[:2]
        flat = encode_image(model, cfg, pixel_values.reshape((B * K,) + pixel_values.shape[2:]),
                            remat=remat)
        image_embeds = flat.reshape((B, K) + flat.shape[1:])
        pos = (img_start_pos.reshape(B, K) if isinstance(img_start_pos, torch.Tensor)
               else np.asarray(img_start_pos).reshape(B, K))
        for k in range(K):
            embeds = splice_image_embeds(embeds, image_embeds[:, k], pos[:, k])
        return embeds
    return splice_image_embeds(embeds, encode_image(model, cfg, pixel_values, remat=remat),
                               img_start_pos)


def prefill_forward(model: VisualCLAModel, cfg: VisualCLAConfig, input_ids: torch.Tensor,
                    attention_mask: torch.Tensor, img_start_pos, pixel_values: Optional[torch.Tensor],
                    kv_cache: dict):
    """Full multimodal prefill from slot 0 into ``kv_cache`` (its slots past
    S start invalid).  -> (fp32 logits (B, S, V), kv_cache)."""
    embeds = multimodal_embeds(model, cfg, input_ids, img_start_pos, pixel_values)
    B, S = input_ids.shape
    positions = (attention_mask.long().cumsum(-1) - 1).clamp(min=0)
    kv_valid = torch.zeros(B, kv_cache["k"].shape[3], dtype=torch.bool, device=embeds.device)
    kv_valid[:, :S] = attention_mask.bool()
    hidden, kv_cache = model.text(embeds, positions, kv_cache, kv_valid, 0)
    return model.text.logits(hidden), kv_cache


def find_img_start(input_ids, img_start_token_id: int) -> torch.Tensor:
    """First position of ``<img>`` per row, or -1.  (B, S) -> (B,) int32."""
    hit = torch.as_tensor(input_ids) == img_start_token_id
    pos = hit.int().argmax(dim=-1).to(torch.int32)
    return torch.where(hit.any(dim=-1), pos, torch.full_like(pos, -1))
