"""LoRA adapter training (port of visualcla_tpu/train/lora.py).

The reference trains VisualCLA with PEFT LoRA over the text tower (q/k/v/o
and the MLP) and the vision tower, with the resampler, the projection and
``embed_tokens`` / ``lm_head`` trained in full.  Here an adapter is a
``LoraLinear`` around the frozen base linear (dense, int8 = QLoRA, or int4 in
forward only), as the JAX package keeps a ``{"w", "lora_A", "lora_B",
"lora_scale"}`` leaf.

- ``add_lora``: wrap the chosen layer linears in place; A ~ N(0, 1/fan_in)
  drawn from an explicit ``torch.Generator`` (it cannot match
  ``jax.random``), B = 0, scale alpha / r;
- ``lora_trainable``: the reference recipe's predicate over JAX paths;
- ``merge_lora``: fold every adapter into a dense base, in place;
- ``export_adapter``: the reference's PEFT layout (``adapter_model.bin`` +
  ``adapter_config.json``), key for key as the JAX package writes it.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Sequence, Tuple

import torch
from torch import nn

from ..checkpoint.from_jax import params_to_jax, wrap_lora_
from ..ops.linear import Int4Linear, Int8Linear, Linear, LoraLinear, base_features
from ..ops.quantization import dequantize_grouped
from ..parallel.distributed import rank
from ..parallel.sharding import held

TEXT_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj",
                "gate_proj", "up_proj", "down_proj")
VISION_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj", "fc1", "fc2")


@torch.no_grad()
def add_lora(model: nn.Module, *, r: int = 8, alpha: float = 16.0,
             generator: torch.Generator, text_targets: Sequence[str] = TEXT_TARGETS,
             vision_targets: Sequence[str] = VISION_TARGETS,
             dtype=torch.float32) -> nn.Module:
    """Wrap the targets of every text and vision layer in a ``LoraLinear``
    over the existing linear, in place (``wrap_lora_``): for each target in
    order, A is one (L, in, r) draw of N(0, 1) times 1 / sqrt(in) in fp32 on
    the generator's device, then cast to ``dtype``; B is zero and the scale
    alpha / r.  -> the model."""
    specs = {}
    for tower, targets in (("text", text_targets), ("vision", vision_targets)):
        for name in targets:
            base = getattr(getattr(model, tower).layers[0], name)
            kind = ("int4" if isinstance(base, Int4Linear)
                    else "int8" if isinstance(base, Int8Linear) else "dense")
            specs[f"{tower}/layers/{name}"] = {"rank": r, "base": kind}
    wrap_lora_(model, specs, dtype=dtype)
    for key in specs:
        tower, _, name = key.split("/")
        mods = [getattr(layer, name) for layer in getattr(model, tower).layers]
        fin = base_features(mods[0].base)[0]
        a = torch.randn(len(mods), fin, r, generator=generator, device=generator.device,
                        dtype=torch.float32) * (1.0 / fin ** 0.5)
        for l, mod in enumerate(mods):
            mod.lora_A.copy_(a[l].t())
            mod.lora_scale.fill_(alpha / r)
    return model


def lora_trainable(path: Tuple) -> bool:
    """Reference SFT recipe: LoRA matrices + full resampler/projector +
    embed_tokens/lm_head (modules_to_save)."""
    if path and path[0] in ("resampler", "projection"):
        return True
    if path and path[-1] in ("lora_A", "lora_B"):
        return True
    if len(path) >= 2 and path[0] == "text" and path[1] in ("embed_tokens", "lm_head"):
        return True
    return False


def _dense_weight(base: nn.Module) -> torch.Tensor:
    """A base linear's (out, in) weight in fp32 (an int8 or int4 base
    dequantized)."""
    if isinstance(base, Int8Linear):
        return base.q.float() * base.scale.t()
    if isinstance(base, Int4Linear):
        return dequantize_grouped(base.q, base.scale, torch.float32).t()
    return base.weight.float()


@torch.no_grad()
def merge_lora(model: nn.Module) -> nn.Module:
    """Fold every ``LoraLinear`` into a dense ``Linear`` in place: W + B A *
    scale in fp32, back to the base's dtype (a quantized base is dequantized
    and folds to the model's float dtype).  Over a mesh each rank folds its
    piece of the base (the rows or columns of B A its shard holds; nothing
    where another rank holds the layer) and the dense layer keeps the
    base's placement.  -> the model."""
    dtype = model.projection.weight.dtype
    for tower in ("text", "vision"):
        for layer in getattr(model, tower).layers:
            for name, mod in list(layer.named_children()):
                if isinstance(mod, LoraLinear):
                    setattr(layer, name, _folded(mod, dtype))
    return model


def _folded(mod: LoraLinear, dtype) -> Linear:
    base = mod.base
    out_dtype = base.weight.dtype if isinstance(base, Linear) else dtype
    carrier = base.weight if isinstance(base, Linear) else base.q
    dim = 1 if getattr(mod, "tp_in", False) else 0 if getattr(mod, "tp_out", False) else None
    if held(carrier):
        w = _dense_weight(base)
        fold = (mod.lora_B.float() @ mod.lora_A.float()) * mod.lora_scale.float()
        if dim is not None:  # this rank's rows (column-parallel) or columns (row-parallel)
            n = w.shape[dim]
            fold = fold.narrow(dim, mod.tp.rank * n, n)
        weight = (w + fold).to(out_dtype)
    else:
        weight = carrier.new_empty(0, dtype=out_dtype)
    dense = Linear(1, 1, False, device="meta")
    dense.weight = nn.Parameter(weight, requires_grad=False)
    dense.bias = mod.bias  # the Parameter, with its placement
    if hasattr(mod, "tp"):
        dense.tp, dense.tp_in, dense.tp_out = mod.tp, mod.tp_in, mod.tp_out
        if dim is not None:
            dense.weight.shard = (mod.tp, dim)
    if hasattr(carrier, "owner"):  # the (out, in) the owner holds
        ax, r, shape = carrier.owner
        if isinstance(base, Int4Linear):  # carrier (G, gs/2, out)
            shape = (shape[2], shape[0] * shape[1] * 2)
        dense.weight.owner = (ax, r, tuple(shape))
    return dense


# HF key formats for export (reverse of checkpoint/mapping.py)
_TEXT_FMT = {
    "q_proj": "model.layers.{}.self_attn.q_proj",
    "k_proj": "model.layers.{}.self_attn.k_proj",
    "v_proj": "model.layers.{}.self_attn.v_proj",
    "o_proj": "model.layers.{}.self_attn.o_proj",
    "gate_proj": "model.layers.{}.mlp.gate_proj",
    "up_proj": "model.layers.{}.mlp.up_proj",
    "down_proj": "model.layers.{}.mlp.down_proj",
}
_VISION_FMT = {
    "q_proj": "vision_model.encoder.layers.{}.self_attn.q_proj",
    "k_proj": "vision_model.encoder.layers.{}.self_attn.k_proj",
    "v_proj": "vision_model.encoder.layers.{}.self_attn.v_proj",
    "o_proj": "vision_model.encoder.layers.{}.self_attn.out_proj",
    "fc1": "vision_model.encoder.layers.{}.mlp.fc1",
    "fc2": "vision_model.encoder.layers.{}.mlp.fc2",
}


def export_adapter(model: nn.Module, out_dir: str, *, r: int, alpha: float) -> None:
    """Write a reference-layout composite adapter: LoRA pairs in PEFT (out,
    in) orientation under ``base_model.model.{text_model|vision_model}``
    prefixes, plus the full resampler, projector, embed_tokens and lm_head
    (the keys of the reference's ``convert_ckpt_for_tgwebui.py``), fp32.
    Over a mesh every rank calls it (the tensors are assembled whole) and
    rank 0 writes."""
    views = params_to_jax(model, stack=False)  # the model's own tensors, not copied
    flat = {k: (torch.stack(v) if isinstance(v, list) else v).float().cpu()
            for k, v in views.items()
            if k.endswith(("/lora_A", "/lora_B")) or k in ("text/embed_tokens", "text/lm_head")
            or k.startswith(("resampler/", "projection/"))}
    sd: Dict[str, torch.Tensor] = {}

    def emit_lora(tower, fmts, prefix):
        for name, fmt in fmts.items():
            key = f"{tower}/layers/{name}"
            if key + "/lora_A" not in flat:
                continue
            A, B = flat[key + "/lora_A"], flat[key + "/lora_B"]  # (L, in, r), (L, r, out)
            for l in range(A.shape[0]):
                base = f"base_model.model.{prefix}{fmt.format(l)}"
                sd[base + ".lora_A.weight"] = A[l].t()  # (r, in)
                sd[base + ".lora_B.weight"] = B[l].t()  # (out, r)

    if any(k.startswith("text/") for k in views):
        emit_lora("text", _TEXT_FMT, "text_model.")
        for name in ("embed_tokens", "lm_head"):
            w = flat.get(f"text/{name}")
            if w is None:  # quantized: not exported
                continue
            key = ("base_model.model.text_model.model.embed_tokens" if name == "embed_tokens"
                   else "base_model.model.text_model.lm_head")
            sd[key + ".modules_to_save.default.weight"] = w if name == "embed_tokens" else w.t()
    if any(k.startswith("vision/") for k in views):
        emit_lora("vision", _VISION_FMT, "vision_model.")
    if any(k.startswith("resampler/") for k in flat):
        sd.update(_export_resampler(flat))
    if "projection/weight" in flat:
        sd["base_model.model.image_projection_layer.weight"] = flat["projection/weight"].t()
        sd["base_model.model.image_projection_layer.bias"] = flat["projection/bias"]

    if rank() != 0:  # over a mesh every rank assembled the tensors; rank 0 writes
        return
    os.makedirs(out_dir, exist_ok=True)
    torch.save({k: v.contiguous().clone() for k, v in sd.items()},
               os.path.join(out_dir, "adapter_model.bin"))
    with open(os.path.join(out_dir, "adapter_config.json"), "w") as f:
        json.dump({"peft_type": "LORA", "r": r, "lora_alpha": alpha,
                   "fan_in_fan_out": False, "bias": "none"}, f, indent=2)


def _export_resampler(flat: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The stacked resampler leaves -> the reference's per-layer key names
    (with its ``query_embeddding`` spelling)."""
    out = {}
    pre = "base_model.model.visual_resampler."
    out[pre + "query_embeddding"] = flat["resampler/query_embedding"][None]
    L = flat["resampler/layers/q_proj"].shape[0]
    cross = pre + "encoder.layer.{}.crossattention."
    ffn = pre + "encoder.layer.{}."
    names = [
        ("q_proj", cross + "self.query.weight", True),
        ("q_bias", cross + "self.query.bias", False),
        ("k_proj", cross + "self.key.weight", True),
        ("k_bias", cross + "self.key.bias", False),
        ("v_proj", cross + "self.value.weight", True),
        ("v_bias", cross + "self.value.bias", False),
        ("attn_out", cross + "output.dense.weight", True),
        ("attn_out_bias", cross + "output.dense.bias", False),
        ("inter", ffn + "intermediate.dense.weight", True),
        ("inter_bias", ffn + "intermediate.dense.bias", False),
        ("out", ffn + "output.dense.weight", True),
        ("out_bias", ffn + "output.dense.bias", False),
    ]
    for l in range(L):
        for ours, fmt, transpose in names:
            t = flat[f"resampler/layers/{ours}"][l]
            out[fmt.format(l)] = t.t() if transpose else t
        for ln_ours, ln_fmt in (("attn_ln", cross + "output.LayerNorm"),
                                ("out_ln", ffn + "output.LayerNorm")):
            for part in ("weight", "bias"):
                out[f"{ln_fmt.format(l)}.{part}"] = flat[f"resampler/layers/{ln_ours}/{part}"][l]
    return out
