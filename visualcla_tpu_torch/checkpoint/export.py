"""This package's models (or a JAX-layout tree) -> the reference's merged
directory (port of visualcla_tpu/checkpoint/export.py, the inverse of
``convert``).

The reference's merge tool writes an HF-consumable merged dir:

  out/
    config.json                   composite VisualCLA config
    pytorch_model.bin             visual_resampler.* + image_projection_layer.*
    text_encoder/                 HF LlamaForCausalLM (config + weights)
    vision_encoder/               HF CLIPVisionModel (config + weights)
    tokenizer.model, preprocessor_config.json, ...  (side files)

``export_reference_merged`` emits that layout with the JAX package's key
names (the reference's triple-d ``query_embeddding`` included), tensor
orientations and configs, so the JAX exporter's files and this one's hold
the same tensors.  LoRA and int8 / int4 leaves are refused: fold and
dequantize first.

    python -m visualcla_tpu_torch.checkpoint.export --checkpoint NATIVE --output DIR
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil

import torch
from torch import nn

from ..core.config import VisualCLAConfig

from .from_jax import as_torch, params_to_jax
from .mapping import sd_from_tower_leaves
from .serialize import TORCH_DTYPES, flatten_tree

logger = logging.getLogger(__name__)

_SIDE_FILES = ("tokenizer.model", "tokenizer_config.json", "special_tokens_map.json",
               "added_tokens.json", "preprocessor_config.json")


def _require_plain(flat: dict) -> None:
    """Exported trees hold plain float leaves: no LoRA, no quantized weight."""
    for key in flat:
        parts = key.split("/")
        if any(p in ("lora_A", "lora_B", "lora_scale", "w") for p in parts):
            raise ValueError(f"param subtree {key} holds LoRA leaves: fold them before export")
        if parts[-1] in ("q", "scale"):
            raise ValueError(f"param subtree {key} holds int8 / int4 leaves: dequantize "
                             "before export")


def _save_bin(sd: dict, path: str, dtype: torch.dtype) -> None:
    torch.save({k: v.to("cpu", dtype).contiguous() for k, v in sd.items()}, path)


def export_reference_merged(params, cfg: VisualCLAConfig, out_dir: str,
                            dtype: str = "float16", side_files_from: str | None = None,
                            tokenizer=None) -> None:
    """Write ``params`` (a ``VisualCLAModel`` or a JAX-layout tree, nested or
    flat) as a reference merged dir.  ``dtype`` is the reference merge tool's
    default (fp16 ``.bin`` files).  ``side_files_from`` copies tokenizer and
    preprocessor files from a directory; ``tokenizer`` (a
    ``VisualCLATokenizer``) writes its ``tokenizer.model`` and
    ``added_tokens.json`` instead."""
    if isinstance(params, nn.Module):  # each tensor leaves the card as it is written
        flat = params_to_jax(params, stack=False)
    else:
        flat = {k: as_torch(v) for k, v in flatten_tree(params).items()}
    _require_plain(flat)
    td = TORCH_DTYPES[dtype]
    towers = {}
    for key, v in flat.items():
        tower, leaf = key.split("/", 1)
        towers.setdefault(tower, {})[leaf] = v
    text_dir = os.path.join(out_dir, "text_encoder")
    vision_dir = os.path.join(out_dir, "vision_encoder")
    os.makedirs(text_dir, exist_ok=True)
    os.makedirs(vision_dir, exist_ok=True)

    _save_bin(sd_from_tower_leaves(towers["text"], "text"),
              os.path.join(text_dir, "pytorch_model.bin"), td)
    with open(os.path.join(text_dir, "config.json"), "w") as f:
        json.dump({**dataclasses.asdict(cfg.text_config), "model_type": "llama",
                   "architectures": ["LlamaForCausalLM"], "torch_dtype": dtype}, f, indent=2)
    _save_bin(sd_from_tower_leaves(towers["vision"], "vision", cfg.vision_config.patch_size),
              os.path.join(vision_dir, "pytorch_model.bin"), td)
    with open(os.path.join(vision_dir, "config.json"), "w") as f:
        json.dump({**dataclasses.asdict(cfg.vision_config), "model_type": "clip_vision_model",
                   "architectures": ["CLIPVisionModel"], "torch_dtype": dtype}, f, indent=2)

    root = sd_from_tower_leaves(towers["projection"], "projection")
    if "resampler" in towers:
        root.update(sd_from_tower_leaves(towers["resampler"], "resampler"))
    _save_bin(root, os.path.join(out_dir, "pytorch_model.bin"), td)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump({
            "model_type": "visualcla",
            "text_config": dataclasses.asdict(cfg.text_config),
            "vision_config": dataclasses.asdict(cfg.vision_config),
            "use_visual_resampler": cfg.use_visual_resampler,
            "visual_resampler_config": dataclasses.asdict(cfg.visual_resampler_config),
            "initializer_range": cfg.initializer_range,
            "layer_norm_eps": cfg.layer_norm_eps,
            "torch_dtype": dtype,
        }, f, indent=2)
    if side_files_from:
        for name in _SIDE_FILES:
            src = os.path.join(side_files_from, name)
            if os.path.exists(src):
                shutil.copy2(src, os.path.join(out_dir, name))
    if tokenizer is not None:
        tokenizer.sp.save(os.path.join(out_dir, "tokenizer.model"))
        with open(os.path.join(out_dir, "added_tokens.json"), "w") as f:
            json.dump(tokenizer.added_tokens, f)
    logger.info("exported reference merged dir -> %s", out_dir)


def main(argv=None):
    import argparse

    from .serialize import iter_safetensors

    ap = argparse.ArgumentParser(
        description="Export a native checkpoint to the reference merged layout")
    ap.add_argument("--checkpoint", required=True, help="native checkpoint dir")
    ap.add_argument("--output", required=True, help="merged dir to write")
    ap.add_argument("--dtype", default="float16", choices=("float16", "bfloat16", "float32"))
    args = ap.parse_args(argv)
    cfg = VisualCLAConfig.from_pretrained(args.checkpoint)
    flat = dict(iter_safetensors(os.path.join(args.checkpoint, "params.safetensors")))
    export_reference_merged(flat, cfg, args.output, dtype=args.dtype,
                            side_files_from=args.checkpoint)


if __name__ == "__main__":
    main()
