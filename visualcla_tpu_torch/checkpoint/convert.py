"""Checkpoint converter CLI: the reference's formats -> a native checkpoint
(port of visualcla_tpu/checkpoint/convert.py).

Two input modes, covering both reference pipelines:

1. **merged dir** (the reference merge script's output): ``text_encoder/`` +
   ``vision_encoder/`` + ``pytorch_model*.bin`` (resampler + projector) +
   ``config.json``.
2. **unmerged**: ``--text_model`` (a LLaMA HF dir) + ``--vision_model`` (a
   CLIP-ViT HF dir) + one or more ``--lora_model`` dirs: resize the
   embeddings to the tokenizer, fold each LoRA (text / vision LoRA pairs,
   full resampler / projector, embed / lm_head ``modules_to_save``) and
   write the same dense result; no PEFT.

Usage:
  python -m visualcla_tpu_torch.checkpoint.convert --merged_model DIR --output OUT
  python -m visualcla_tpu_torch.checkpoint.convert --text_model DIR --vision_model DIR \\
      --lora_model LORA1,LORA2 --output OUT [--dtype bfloat16]

Both builds consume their state dicts as they stack them (a 7B text state
dict is 13.5 GB; holding it and the stacked tree at once doubles that) and
the writer drops each leaf once written.  The output is the JAX package's
``params.safetensors`` byte for byte.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import shutil
from typing import Optional

import torch

from ..core.config import LlamaConfig, ViTConfig, VisualCLAConfig

from . import lora as lora_lib
from .mapping import iter_leaves, tower_tree_from_sd
from .serialize import StatePlacer, check_quantize, flatten_tree, save_checkpoint, unflatten_tree
from .torch_io import load_state_dict

logger = logging.getLogger(__name__)

SIDE_FILES = ("tokenizer.model", "added_tokens.json", "special_tokens_map.json",
              "tokenizer_config.json", "preprocessor_config.json")


def _copy_side_files(src_dirs, out_dir):
    for name in SIDE_FILES:
        for d in src_dirs:
            if d and os.path.exists(os.path.join(d, name)):
                shutil.copy(os.path.join(d, name), os.path.join(out_dir, name))
                break


def convert_merged(merged_dir: str, out_dir: str, dtype: str = "bfloat16") -> None:
    """Reference merged checkpoint -> native format, each state dict consumed
    as its tower is stacked."""
    cfg = VisualCLAConfig.from_pretrained(merged_dir)
    sd = load_state_dict(os.path.join(merged_dir, "text_encoder"))
    params = {"text": unflatten_tree(tower_tree_from_sd(sd, "text", consume=True))}
    sd = load_state_dict(os.path.join(merged_dir, "vision_encoder"))
    params["vision"] = unflatten_tree(tower_tree_from_sd(sd, "vision", consume=True))
    sd = load_state_dict(merged_dir)
    params["projection"] = unflatten_tree(tower_tree_from_sd(sd, "projection"))
    if cfg.use_visual_resampler:
        params["resampler"] = unflatten_tree(tower_tree_from_sd(sd, "resampler"))
    del sd
    # the tensor shapes win over the stored config
    cfg = _sync_config(cfg, params)
    save_checkpoint(out_dir, params, cfg, dtype, consume=True)
    _copy_side_files([merged_dir], out_dir)
    logger.info("converted merged checkpoint %s -> %s", merged_dir, out_dir)


def unmerged_state(text_model: str, vision_model: str, lora_models: list,
                   vocab_size: Optional[int] = None, device=None):
    """(text sd, vision sd, resampler sd, projection sd, config or None) of
    base dirs with each LoRA folded in order.  The two towers come back as
    ``lora.FoldingStateDict``: each tensor is moved to ``device`` (None: left
    on the host), resized and folded only when it is read, so the folded
    towers never exist in full."""
    text_sd = lora_lib.FoldingStateDict(load_state_dict(text_model), device)
    vision_sd = lora_lib.FoldingStateDict(load_state_dict(vision_model), device)
    resampler_sd, projection_sd, cfg = {}, {}, None
    for lora_dir in lora_models:
        adapter_sd, adapter_cfg = lora_lib.load_adapter(lora_dir)
        comp = lora_lib.partition_visualcla_adapter(adapter_sd)
        if vocab_size is None:  # the post-resize vocab from the adapter's full embedding
            for k, v in comp["text_model"].items():
                if "embed_tokens" in k and "lora" not in k:
                    vocab_size = v.shape[0]
        if vocab_size:
            text_sd.resize(vocab_size)
        text_sd.fold(comp["text_model"], adapter_cfg)
        if comp["vision_model"]:
            vision_sd.fold(comp["vision_model"], adapter_cfg)
        for k, v in comp["visual_resampler"].items():  # full weights inside the adapter
            resampler_sd["visual_resampler." + k] = v
        for k, v in comp["image_projection_layer"].items():
            projection_sd["image_projection_layer." + k] = v
        cfg_path = os.path.join(lora_dir, "config.json")
        if os.path.exists(cfg_path):
            cfg = VisualCLAConfig.from_pretrained(cfg_path)
    if not lora_models and vocab_size:
        # the resize normally happens per LoRA; an explicit vocab_size
        # (len(tokenizer) with the added specials) holds without one too
        text_sd.resize(vocab_size)
    return text_sd, vision_sd, resampler_sd, projection_sd, cfg


def base_config(text_model: str, vision_model: str) -> VisualCLAConfig:
    """The composite config from the base towers' own HF configs (heads, eps
    and the like are not derivable from weight shapes)."""
    cfg = VisualCLAConfig()
    for d, field, klass in ((text_model, "text_config", LlamaConfig),
                            (vision_model, "vision_config", ViTConfig)):
        p = os.path.join(d, "config.json")
        if os.path.exists(p):
            with open(p) as f:
                hf = json.load(f)
            if field == "vision_config":
                hf = hf.get("vision_config", hf)  # CLIPModel nests it
            cfg = dataclasses.replace(cfg, **{field: klass.from_hf_dict(hf)})
    return cfg


def convert_unmerged(text_model: str, vision_model: str, lora_models: list, out_dir: str,
                     dtype: str = "bfloat16", vocab_size: Optional[int] = None) -> None:
    """Base LLaMA + CLIP + VisualCLA LoRA(s) -> folded dense native checkpoint."""
    text_sd, vision_sd, resampler_sd, projection_sd, cfg = unmerged_state(
        text_model, vision_model, lora_models, vocab_size)
    if cfg is None:
        cfg = base_config(text_model, vision_model)
    params = {"text": unflatten_tree(tower_tree_from_sd(text_sd, "text", consume=True)),
              "vision": unflatten_tree(tower_tree_from_sd(vision_sd, "vision", consume=True))}
    del text_sd, vision_sd
    if projection_sd:
        params["projection"] = unflatten_tree(tower_tree_from_sd(projection_sd, "projection"))
    if resampler_sd and cfg.use_visual_resampler:
        params["resampler"] = unflatten_tree(tower_tree_from_sd(resampler_sd, "resampler"))
    params, cfg = _init_missing_heads(params, _sync_config(cfg, params))
    save_checkpoint(out_dir, params, cfg, dtype, consume=True)
    _copy_side_files(list(lora_models) + [text_model, vision_model], out_dir)
    logger.info("converted unmerged %s + %s + %s -> %s",
                text_model, vision_model, lora_models, out_dir)


def fresh_resampler_config(cfg: VisualCLAConfig) -> VisualCLAConfig:
    """A fresh resampler consumes the actual vision width, not the default
    config's (the reference ties the resampler's hidden size to the ViT)."""
    vh = cfg.vision_config.hidden_size
    res = cfg.visual_resampler_config
    if res.hidden_size == vh:
        return cfg
    heads = res.num_attention_heads
    if vh % heads:
        heads = max(1, vh // 64)
    res = dataclasses.replace(res, hidden_size=vh, intermediate_size=4 * vh,
                              num_attention_heads=heads)
    return dataclasses.replace(cfg, visual_resampler_config=res)


def _init_missing_heads(params: dict, cfg: VisualCLAConfig):
    """Without a LoRA the resampler and projector have no trained weights:
    the reference builds them freshly initialized (normal(0,
    initializer_range) matrices, zero biases, zero resampler queries, unit
    layer norms) so the composite runs before an adapter is applied.  The
    draws come from a ``torch.Generator`` seeded with 0 (the JAX package
    draws the same distributions from its own generator).  Returns
    (params, cfg) with the resampler config synced to the vision width."""
    vh = cfg.vision_config.hidden_size
    th = cfg.text_config.hidden_size
    std = cfg.initializer_range
    gen = torch.Generator().manual_seed(0)

    def normal(*shape, scale=std):
        return torch.randn(*shape, generator=gen) * scale

    if "projection" not in params:
        params["projection"] = {"weight": normal(vh, th), "bias": torch.zeros(th)}
    if cfg.use_visual_resampler and "resampler" not in params:
        cfg = fresh_resampler_config(cfg)
        res = cfg.visual_resampler_config
        L, H, I = res.num_hidden_layers, res.hidden_size, res.intermediate_size

        def ln():
            return {"weight": torch.ones(L, H), "bias": torch.zeros(L, H)}

        params["resampler"] = {
            "query_embedding": torch.zeros(res.num_query_tokens, H),
            "layers": {
                "q_proj": normal(L, H, H, scale=0.02), "q_bias": torch.zeros(L, H),
                "k_proj": normal(L, H, H, scale=0.02), "k_bias": torch.zeros(L, H),
                "v_proj": normal(L, H, H, scale=0.02), "v_bias": torch.zeros(L, H),
                "attn_out": normal(L, H, H, scale=0.02), "attn_out_bias": torch.zeros(L, H),
                "attn_ln": ln(),
                "inter": normal(L, H, I, scale=0.02), "inter_bias": torch.zeros(L, I),
                "out": normal(L, I, H, scale=0.02), "out_bias": torch.zeros(L, H),
                "out_ln": ln(),
            },
        }
        if res.add_pooling_layer:
            params["resampler"]["pooler"] = {"weight": normal(H, H, scale=0.02),
                                             "bias": torch.zeros(H)}
        # in key order at every level, as the JAX package's tree map leaves it
        params["resampler"] = _sorted_tree(params["resampler"])
    return params, cfg


def _sorted_tree(tree):
    return {k: _sorted_tree(tree[k]) for k in sorted(tree)} if isinstance(tree, dict) else tree


# ---------------------------------------------------------------------------
# straight onto the modules, without a native checkpoint in between
# ---------------------------------------------------------------------------

def load_state_dicts(sds: dict, cfg: VisualCLAConfig, *, device, dtype=torch.bfloat16,
                     quantize: str = "none", towers_only: bool = False):
    """-> (model, config) from reference state dicts ``{tower: (sd, prefix
    or None)}``: the config is synced to the tensors' shapes, a missing
    projector / resampler is made fresh (``_init_missing_heads``), and each
    tensor goes onto ``device`` as it is read (consumed from its dict),
    quantized on the host first at the int8 / int4 tier.  HF's (out, in) is
    the modules' own layout, so no tower is restacked or transposed.
    ``towers_only``: the vision side alone (``VisionTowers``)."""
    from ..models.visualcla import VisionTowers, VisualCLAModel

    check_quantize(quantize)
    shapes = {}
    for tower, (sd, prefix) in sds.items():
        shape = sd.shape if isinstance(sd, lora_lib.FoldingStateDict) else (lambda k: sd[k].shape)
        meta = {k: torch.empty(shape(k), device="meta") for k in sd}
        shapes[tower] = unflatten_tree(tower_tree_from_sd(meta, tower, prefix))
    cfg = _sync_config(cfg, shapes)
    fresh, cfg = _init_missing_heads(shapes, cfg)
    if towers_only:
        model = VisionTowers(cfg, device=device, dtype=dtype)
    else:
        model = VisualCLAModel(cfg, device=device, dtype=dtype, quant=quantize)
    placer = StatePlacer(model, cfg, quantize)
    with torch.no_grad():
        for tower, (sd, prefix) in sds.items():
            for key, layer, t in iter_leaves(sd, tower, prefix, consume=True):
                placer.put(key, t, layer)
        for tower in ("projection", "resampler"):
            if tower not in sds and tower in fresh:
                for key, t in flatten_tree({tower: fresh[tower]}).items():
                    placer.put(key, t)
    placer.finish()
    return model, cfg


def load_merged(merged_dir: str, *, device, dtype=torch.bfloat16, quantize: str = "none"):
    """A reference merged dir -> (VisualCLAModel on ``device``, config)."""
    cfg = VisualCLAConfig.from_pretrained(merged_dir)
    root = load_state_dict(merged_dir)
    sds = {"text": (load_state_dict(os.path.join(merged_dir, "text_encoder")), None),
           "vision": (load_state_dict(os.path.join(merged_dir, "vision_encoder")), None),
           "projection": (root, None)}
    if cfg.use_visual_resampler:
        sds["resampler"] = (root, None)
    return load_state_dicts(sds, cfg, device=device, dtype=dtype, quantize=quantize)


def load_unmerged(text_model: str, vision_model: str, lora_models: list, *, device,
                  dtype=torch.bfloat16, quantize: str = "none",
                  vocab_size: Optional[int] = None):
    """Base dirs + LoRAs -> (VisualCLAModel on ``device``, config).  One base
    tensor at a time moves to ``device``, takes its folds there in fp32
    (``lora.fold_pair``) and is placed in the modules.  At the int8 / int4
    tier the folds run on the host, where the placer quantizes, so no dense
    text weight reaches the card."""
    text_sd, vision_sd, resampler_sd, projection_sd, cfg = unmerged_state(
        text_model, vision_model, lora_models, vocab_size,
        device=device if quantize == "none" else None)
    if cfg is None:
        cfg = base_config(text_model, vision_model)
    sds = {"text": (text_sd, None), "vision": (vision_sd, None)}
    if projection_sd:
        sds["projection"] = (projection_sd, None)
    if resampler_sd and cfg.use_visual_resampler:
        sds["resampler"] = (resampler_sd, None)
    return load_state_dicts(sds, cfg, device=device, dtype=dtype, quantize=quantize)


def _sync_config(cfg: VisualCLAConfig, params: dict) -> VisualCLAConfig:
    """Align the config's dimensions with the tensors (vocab after a resize,
    depth, widths; patch and image size from the vision tables).  Without a
    text tower (the vision side alone) the text width is the projection's."""
    v = params["vision"]
    if "text" in params:
        t = params["text"]
        text = dataclasses.replace(
            cfg.text_config,
            vocab_size=int(t["embed_tokens"].shape[0]),
            hidden_size=int(t["embed_tokens"].shape[1]),
            num_hidden_layers=int(t["layers"]["q_proj"].shape[0]),
            intermediate_size=int(t["layers"]["gate_proj"].shape[2]))
    else:
        text = dataclasses.replace(cfg.text_config,
                                   hidden_size=int(params["projection"]["weight"].shape[1]))
    # patch_embedding is the flattened (3 P P, H) filter; position_embedding
    # has (image / P)^2 + 1 rows
    patch = int(round((v["patch_embedding"].shape[0] // 3) ** 0.5))
    grid = int(round((v["position_embedding"].shape[0] - 1) ** 0.5))
    vision = dataclasses.replace(
        cfg.vision_config,
        hidden_size=int(v["class_embedding"].shape[0]),
        num_hidden_layers=int(v["layers"]["q_proj"].shape[0]),
        intermediate_size=int(v["layers"]["fc1"].shape[2]),
        patch_size=patch, image_size=grid * patch)
    res = cfg.visual_resampler_config
    if "resampler" in params:
        r = params["resampler"]
        res = dataclasses.replace(
            res,
            hidden_size=int(r["query_embedding"].shape[1]),
            num_query_tokens=int(r["query_embedding"].shape[0]),
            num_hidden_layers=int(r["layers"]["q_proj"].shape[0]),
            intermediate_size=int(r["layers"]["inter"].shape[2]),
            add_pooling_layer="pooler" in r)
    return dataclasses.replace(cfg, text_config=text, vision_config=vision,
                               visual_resampler_config=res)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--merged_model", default=None, help="reference merged checkpoint dir")
    ap.add_argument("--text_model", default=None, help="base LLaMA HF dir")
    ap.add_argument("--vision_model", default=None, help="base CLIP HF dir")
    ap.add_argument("--lora_model", default=None,
                    help="comma-separated VisualCLA LoRA dirs (applied in order)")
    ap.add_argument("--output", required=True)
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float16", "float32"))
    ap.add_argument("--vocab_size", type=int, default=None)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.merged_model:
        convert_merged(args.merged_model, args.output, args.dtype)
    else:
        if not (args.text_model and args.vision_model and args.lora_model):
            ap.error("need --merged_model OR --text_model+--vision_model+--lora_model")
        convert_unmerged(args.text_model, args.vision_model, args.lora_model.split(","),
                         args.output, args.dtype, args.vocab_size)


if __name__ == "__main__":
    main()
