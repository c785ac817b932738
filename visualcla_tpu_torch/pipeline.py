"""Standalone vision pipeline, the webui multimodal-plugin equivalent (port
of visualcla_tpu/pipeline.py).

The reference's text-generation-webui plugin loads CLIP + resampler +
projector WITHOUT the LLM and embeds images into 64 LLM-space vectors of
width 4096 for injection by an external host.  ``VisionPipeline`` does that
on PyTorch from a native checkpoint directory (only the vision-side leaves
are read), a reference merged directory (only ``vision_encoder/`` and the
root ``pytorch_model*.bin``), the webui split format (a CLIP base, its vision
LoRA folded in, the resampler and projector files) or modules already on the
card, and runs on ``cuda`` unless ``device="cpu"`` is passed.  The encode
replays a CUDA graph captured per (batch, resolution, vision attention)
(``CapturedEncode``; eagerly on CPU tensors).
"""
from __future__ import annotations

import json
import os
import threading

import numpy as np
import torch
from torch import nn

from .core.config import ResamplerConfig, ViTConfig, VisualCLAConfig
from .processor import ImageProcessor

from .api import _default_device
from .checkpoint import lora as lora_lib
from .checkpoint.convert import load_state_dicts
from .checkpoint.from_jax import build_model
from .checkpoint.serialize import flatten_tree, iter_safetensors
from .checkpoint.torch_io import load_file, load_state_dict
from .engine.generate import host_pixels
from .engine.graphs import Graphs
from .models.visualcla import encode_image
from .ops.attention import vision_attention_impl

VISION_TREES = ("vision/", "resampler/", "projection/")


class CapturedEncode:
    """``encode_image`` of a module holding ``vision``, ``resampler`` and
    ``projection``, replayed from a graph captured per (batch, resolution,
    ``VISUALCLA_VIT_ATTN``) on the card, eagerly on CPU tensors: the pixels
    go into a static buffer of their shape, the graph writes its output
    tensor, and a copy of it is returned.  Calls run one at a time."""

    def __init__(self, towers: nn.Module, cfg: VisualCLAConfig):
        self.towers, self.cfg = towers, cfg
        w = towers.projection.weight
        self.device, self.dtype = w.device, w.dtype
        self.graphs = Graphs()
        self.counts = {"encode_passes": 0}  # encodes run (a capture's warm-up is one)
        self._pixels: dict = {}  # shape -> static pixel buffer
        self._out: dict = {}  # shape -> the last encode's output
        self._lock = threading.Lock()

    def _step(self, key) -> None:
        self._out[key] = encode_image(self.towers, self.cfg, self._pixels[key])
        self.counts["encode_passes"] += 1

    @torch.no_grad()
    def __call__(self, pixel_values) -> torch.Tensor:
        """(B, 3, H, W) pixels (numpy or a tensor) -> (B, T, text hidden) in
        the towers' dtype, on their device."""
        src = host_pixels(pixel_values)
        key = tuple(src.shape)
        with self._lock:
            if key not in self._pixels:
                self._pixels[key] = torch.zeros(key, dtype=self.dtype, device=self.device)
            self._pixels[key].copy_(src)
            self.graphs.run(("encode", key, vision_attention_impl()), lambda: self._step(key),
                            self.device, counters=[self.counts], space="prefill")
            return self._out[key].clone()


class VisionPipeline:
    """images -> (N, num_image_tokens, llm_hidden) embeddings.

    ``params`` is a module holding ``vision``, ``resampler`` and
    ``projection`` (a ``VisualCLAModel`` or ``VisionTowers``, used as it is:
    ``dtype`` and ``device`` are then its own), or the JAX package's
    vision-side parameter tree, nested or flat, converted and placed on
    ``device`` (``cuda`` by default; raises without a GPU) in ``dtype``."""

    def __init__(self, params, cfg: VisualCLAConfig, image_processor=None,
                 dtype=torch.bfloat16, device=None):
        if isinstance(params, nn.Module):
            towers = params
        else:
            flat = {k: v for k, v in flatten_tree(params).items() if k.startswith(VISION_TREES)}
            towers = build_model(flat, cfg, device=device or _default_device(), dtype=dtype,
                                 towers=True)
        self.towers = towers
        self.cfg = cfg
        self.image_processor = image_processor or ImageProcessor(
            image_size=cfg.vision_config.image_size, patch_size=cfg.vision_config.patch_size)
        w = towers.projection.weight
        self.device, self.dtype = w.device, w.dtype
        self.encode = CapturedEncode(towers, cfg)

    @property
    def num_image_embeds(self) -> int:
        """64 for the shipped model (the webui plugin's count)."""
        return self.cfg.num_image_tokens

    @torch.no_grad()
    def embed_images(self, images) -> np.ndarray:
        """One image or a list (paths, PIL images, uint8 (H, W, 3) arrays) ->
        float32 numpy (N, num_image_embeds, llm_hidden), one encode for all
        (a replay of the encode captured for N images of this size)."""
        pixel_values = self.image_processor(images)["pixel_values"]
        return self.encode(pixel_values).float().cpu().numpy()

    # -- loaders ---------------------------------------------------------------

    @classmethod
    def from_pretrained(cls, path: str, dtype=torch.bfloat16, device=None) -> "VisionPipeline":
        """Load from a native checkpoint dir, reading the vision-side leaves only."""
        cfg = VisualCLAConfig.from_pretrained(path)
        flat = dict(iter_safetensors(os.path.join(path, "params.safetensors"), VISION_TREES))
        return cls(flat, cfg, _image_processor(path), dtype=dtype, device=device)

    @classmethod
    def from_reference_merged(cls, path: str, dtype=torch.bfloat16,
                              device=None) -> "VisionPipeline":
        """Load the vision side of a reference merged dir (``vision_encoder/``
        + the root ``pytorch_model*.bin`` with ``visual_resampler.*`` and
        ``image_projection_layer.*``), never reading the text tower."""
        cfg = VisualCLAConfig.from_pretrained(path)
        root = load_state_dict(path)
        sds = {"vision": (load_state_dict(os.path.join(path, "vision_encoder")), None),
               "projection": (root, None)}
        if cfg.use_visual_resampler:  # no visual_resampler.* keys without it
            sds["resampler"] = (root, None)
        towers, cfg = load_state_dicts(sds, cfg, device=device or _default_device(),
                                       dtype=dtype, towers_only=True)
        return cls(towers, cfg, _image_processor(path))

    @classmethod
    def from_webui_split(cls, vision_dir: str, clip_model: str, vision_lora=None,
                         dtype=torch.bfloat16, device=None) -> "VisionPipeline":
        """Load the split format of ``checkpoint.split_adapter``: the CLIP base
        (its vision LoRA folded in, from ``vision_lora`` or ``vision_dir``'s
        own ``adapter_model.bin``), the full resampler and projector files,
        the resampler config beside them and the ViT config from the CLIP
        dir (flat or nested under ``vision_config``)."""
        clip_sd = load_state_dict(clip_model)
        if vision_lora or os.path.exists(os.path.join(vision_dir, "adapter_model.bin")):
            asd, acfg = lora_lib.load_adapter(vision_lora or vision_dir)
            clip_sd = lora_lib.fold_lora(clip_sd, asd, acfg)
        with open(os.path.join(vision_dir, "visual_resampler_config.json")) as f:
            res_cfg = ResamplerConfig.from_hf_dict(json.load(f))
        with open(os.path.join(clip_model, "config.json")) as f:
            clip_cfg = json.load(f)
        cfg = VisualCLAConfig(vision_config=ViTConfig.from_hf_dict(
            clip_cfg.get("vision_config", clip_cfg)), visual_resampler_config=res_cfg)
        sds = {"vision": (clip_sd, None),
               "resampler": (load_file(os.path.join(vision_dir, "visual_resampler_model.bin")),
                             ""),
               "projection": (load_file(os.path.join(vision_dir,
                                                     "image_projection_layer_model.bin")), "")}
        towers, cfg = load_state_dicts(sds, cfg, device=device or _default_device(),
                                       dtype=dtype, towers_only=True)
        return cls(towers, cfg)

    @classmethod
    def from_any(cls, path: str, dtype=torch.bfloat16, device=None,
                 **kwargs) -> "VisionPipeline":
        """Sniff the checkpoint layout and dispatch: native (params.safetensors),
        reference merged (vision_encoder/), or webui split
        (visual_resampler_model.bin, with ``clip_model=``)."""
        if os.path.exists(os.path.join(path, "params.safetensors")):
            return cls.from_pretrained(path, dtype=dtype, device=device)
        if os.path.isdir(os.path.join(path, "vision_encoder")):
            return cls.from_reference_merged(path, dtype=dtype, device=device)
        if os.path.exists(os.path.join(path, "visual_resampler_model.bin")):
            clip_model = kwargs.pop("clip_model", None)
            if clip_model is None:
                raise ValueError(f"{path} is a webui-split vision dir; pass clip_model="
                                 "<CLIP checkpoint dir> to load it")
            return cls.from_webui_split(path, clip_model, dtype=dtype, device=device, **kwargs)
        raise FileNotFoundError(
            f"{path}: no params.safetensors, vision_encoder/, or "
            "visual_resampler_model.bin — not a recognizable checkpoint layout")


def _image_processor(path: str):
    """The dir's preprocessor config, if it ships one."""
    if os.path.exists(os.path.join(path, "preprocessor_config.json")):
        return ImageProcessor.from_pretrained(path)
    return None


# -- pipeline registry (the reference webui plugin's) --------------------------

PIPELINES = {"visualcla-7b": VisionPipeline}


def get_pipeline(name: str, *args, **kwargs):
    if name in PIPELINES:
        return PIPELINES[name], name
    return None, None


def get_pipeline_from_model_name(model_name: str, *args, **kwargs):
    """Name-sniffing lookup like the reference ('visualcla' + '7b' in name)."""
    lowered = model_name.lower()
    if "visualcla" in lowered and "7b" in lowered:
        return PIPELINES["visualcla-7b"], "visualcla-7b"
    return None, None
