"""Seeded random weights of a configuration, made on the card in one draw.

Every tensor is named as in the published checkpoints (HF LLaMA, HF CLIP
vision, VisualCLA's resampler and projection), and all of them are views of
one flat buffer drawn by a single ``torch.randn`` from a generator seeded
with the run's seed, in the type the model is served in: so the program and
the plain reference read the same numbers, and the reference can draw them
again after the program is gone.  Matrices, embeddings and biases are
N(0, 0.02^2); norm weights 1 + N(0, 0.1^2), so that a norm that drops its
weight shows.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

STD = 0.02
NORM_STD = 0.1


def text_spec(t: dict) -> List[Tuple[str, tuple, str]]:
    H, I, V = t["hidden_size"], t["intermediate_size"], t["vocab_size"]
    N = t["num_attention_heads"]
    Nkv = t.get("num_key_value_heads") or N
    hd = H // N
    out = [("model.embed_tokens.weight", (V, H), "w")]
    for l in range(t["num_hidden_layers"]):
        p = f"model.layers.{l}."
        out += [(p + "input_layernorm.weight", (H,), "norm"),
                (p + "self_attn.q_proj.weight", (N * hd, H), "w"),
                (p + "self_attn.k_proj.weight", (Nkv * hd, H), "w"),
                (p + "self_attn.v_proj.weight", (Nkv * hd, H), "w"),
                (p + "self_attn.o_proj.weight", (H, N * hd), "w"),
                (p + "post_attention_layernorm.weight", (H,), "norm"),
                (p + "mlp.gate_proj.weight", (I, H), "w"),
                (p + "mlp.up_proj.weight", (I, H), "w"),
                (p + "mlp.down_proj.weight", (H, I), "w")]
    return out + [("model.norm.weight", (H,), "norm"), ("lm_head.weight", (V, H), "w")]


def _ln(name: str, n: int):
    return [(name + ".weight", (n,), "norm"), (name + ".bias", (n,), "w")]


def _lin(name: str, n_out: int, n_in: int):
    return [(name + ".weight", (n_out, n_in), "w"), (name + ".bias", (n_out,), "w")]


def vision_spec(v: dict) -> List[Tuple[str, tuple, str]]:
    H, I, P = v["hidden_size"], v["intermediate_size"], v["patch_size"]
    seq = (v["image_size"] // P) ** 2 + 1
    p = "vision_model."
    out = [(p + "embeddings.class_embedding", (H,), "w"),
           (p + "embeddings.patch_embedding.weight", (H, 3, P, P), "w"),
           (p + "embeddings.position_embedding.weight", (seq, H), "w"),
           *_ln(p + "pre_layrnorm", H)]
    for l in range(v["num_hidden_layers"]):
        q = f"{p}encoder.layers.{l}."
        out += [*_ln(q + "layer_norm1", H),
                *_lin(q + "self_attn.q_proj", H, H), *_lin(q + "self_attn.k_proj", H, H),
                *_lin(q + "self_attn.v_proj", H, H), *_lin(q + "self_attn.out_proj", H, H),
                *_ln(q + "layer_norm2", H),
                *_lin(q + "mlp.fc1", I, H), *_lin(q + "mlp.fc2", H, I)]
    return out + _ln(p + "post_layernorm", H)


def resampler_spec(r: dict) -> List[Tuple[str, tuple, str]]:
    H, I = r["hidden_size"], r["intermediate_size"]
    p = "visual_resampler."
    out = [(p + "query_embeddding", (1, r["num_query_tokens"], H), "w")]
    for l in range(r["num_hidden_layers"]):
        x = f"{p}encoder.layer.{l}.crossattention."
        f = f"{p}encoder.layer.{l}."
        out += [*_lin(x + "self.query", H, H), *_lin(x + "self.key", H, H),
                *_lin(x + "self.value", H, H), *_lin(x + "output.dense", H, H),
                *_ln(x + "output.LayerNorm", H),
                *_lin(f + "intermediate.dense", I, H), *_lin(f + "output.dense", H, I),
                *_ln(f + "output.LayerNorm", H)]
    return out


def spec(cfg: dict) -> Dict[str, List[Tuple[str, tuple, str]]]:
    """Tower -> [(name, shape, kind)] in draw order; kind "w" or "norm"."""
    return {"text": text_spec(cfg["text_config"]),
            "vision": vision_spec(cfg["vision_config"]),
            "resampler": resampler_spec(cfg["visual_resampler_config"]),
            "projection": _lin("image_projection_layer", cfg["text_config"]["hidden_size"],
                               cfg["visual_resampler_config"]["hidden_size"])}


@torch.no_grad()
def make(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> Dict[str, Dict[str, torch.Tensor]]:
    """Tower -> {name: tensor}, views of one flat buffer.  All "w" entries come
    first in the buffer and all "norm" entries after them, so the draw and
    its two affine maps are three calls."""
    towers = spec(cfg)
    flat_entries = [(t, n, s, k) for t, es in towers.items() for n, s, k in es]
    order = ([e for e in flat_entries if e[3] == "w"]
             + [e for e in flat_entries if e[3] == "norm"])
    sizes = []
    for e in order:
        k = 1
        for d in e[2]:
            k *= d
        sizes.append(k)
    n_w = sum(s for s, e in zip(sizes, order) if e[3] == "w")
    gen = torch.Generator(device=device).manual_seed(int(seed))
    buf = torch.randn(sum(sizes), generator=gen, device=device, dtype=dtype)
    buf[:n_w].mul_(STD)
    buf[n_w:].mul_(NORM_STD).add_(1.0)
    out: Dict[str, Dict[str, torch.Tensor]] = {t: {} for t in towers}
    at = 0
    for (tower, name, shape, _), k in zip(order, sizes):
        out[tower][name] = buf[at:at + k].view(shape)
        at += k
    return out
