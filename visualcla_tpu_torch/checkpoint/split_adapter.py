"""Adapter splitter CLI (port of visualcla_tpu/checkpoint/split_adapter.py,
the reference's webui conversion).

Splits a composite VisualCLA LoRA directory into the webui-consumable pieces:
  <out>_text_lora_model/    adapter_model.bin (text LoRA) + adapter_config.json
                            with modules_to_save=[embed_tokens, lm_head] and the
                            reference's target_modules regex
  <out>_vision_lora_model/  adapter_model.bin (vision LoRA),
                            visual_resampler_model.bin,
                            image_projection_layer_model.bin,
                            visual_resampler_config.json

Usage: python -m visualcla_tpu_torch.checkpoint.split_adapter --lora_model DIR [--out_prefix P]
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil

import torch

from .lora import load_adapter

TEXT_TARGET_MODULES = (
    ".*(self_attn|mlp).*(q_proj|k_proj|v_proj|o_proj|gate_proj|down_proj|up_proj)$"
)


def split(lora_dir: str, out_prefix: str | None = None) -> tuple:
    """-> (text dir, vision dir) written from the composite adapter."""
    adapter_sd, adapter_cfg = load_adapter(lora_dir)
    base = out_prefix or lora_dir.rstrip("/\\")
    text_dir = base + "_text_lora_model"
    vision_dir = base + "_vision_lora_model"
    os.makedirs(text_dir, exist_ok=True)
    os.makedirs(vision_dir, exist_ok=True)

    # the resampler config rides along for the standalone vision pipeline
    cfg_path = os.path.join(lora_dir, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            res_cfg = json.load(f).get("visual_resampler_config", {})
        with open(os.path.join(vision_dir, "visual_resampler_config.json"), "w") as f:
            json.dump(res_cfg, f, indent=2)

    text_cfg = dict(adapter_cfg)
    text_cfg["modules_to_save"] = ["embed_tokens", "lm_head"]
    text_cfg["target_modules"] = TEXT_TARGET_MODULES
    with open(os.path.join(text_dir, "adapter_config.json"), "w") as f:
        json.dump(text_cfg, f, indent=2)
    if os.path.exists(os.path.join(lora_dir, "adapter_config.json")):
        shutil.copy(os.path.join(lora_dir, "adapter_config.json"),
                    os.path.join(vision_dir, "adapter_config.json"))

    buckets = {"text": {}, "vision": {}, "resampler": {}, "projection": {}}
    for k, v in adapter_sd.items():
        norm = re.sub(r"^base_model\.model\.", "", k)
        if norm.startswith("vision_model."):
            # one composite level dropped: vision_model.vision_model... -> vision_model...
            buckets["vision"]["base_model.model." + norm[len("vision_model."):]] = v
        elif norm.startswith("text_model."):
            buckets["text"]["base_model.model." + norm[len("text_model."):]] = v
        elif norm.startswith("visual_resampler."):
            buckets["resampler"][norm[len("visual_resampler."):]] = v
        elif norm.startswith("image_projection_layer."):
            buckets["projection"][norm[len("image_projection_layer."):]] = v

    def save(sd, path):
        torch.save({k: v.clone() for k, v in sd.items()}, path)

    save(buckets["text"], os.path.join(text_dir, "adapter_model.bin"))
    save(buckets["vision"], os.path.join(vision_dir, "adapter_model.bin"))
    save(buckets["resampler"], os.path.join(vision_dir, "visual_resampler_model.bin"))
    save(buckets["projection"], os.path.join(vision_dir, "image_projection_layer_model.bin"))
    return text_dir, vision_dir


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--lora_model", required=True, help="Path to VisualCLA LoRA")
    ap.add_argument("--out_prefix", default=None)
    args = ap.parse_args(argv)
    t, v = split(args.lora_model, args.out_prefix)
    print(f"text LoRA -> {t}\nvision pieces -> {v}")


if __name__ == "__main__":
    main()
