"""Offline LoRA folding on reference-layout state dicts (port of
visualcla_tpu/checkpoint/lora.py), the replacement for PEFT's
``merge_and_unload``.

Works on torch-layout state dicts before they are mapped, so an adapter's
key paths line up with its base checkpoint's:
- lora_A / lora_B pairs: ``W += (B @ A) * (alpha / r)`` in fp32 (``alpha /
  sqrt(r)`` with ``use_rslora``; transposed with ``fan_in_fan_out``), the
  result in W's dtype;
- ``modules_to_save`` full replacements (embed_tokens / lm_head after the
  tokenizer-size resize);
- the tokenizer-driven embedding resize: new rows are drawn N(0,
  initializer_range) from numpy's ``default_rng(seed)``, the JAX package's
  draws exactly.
"""
from __future__ import annotations

import json
import math
import os
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

SD = Dict[str, torch.Tensor]


def load_adapter(lora_dir: str) -> Tuple[SD, dict]:
    """Read adapter_model.bin/.safetensors + adapter_config.json."""
    from .torch_io import load_state_dict

    sd = load_state_dict(lora_dir)
    cfg_path = os.path.join(lora_dir, "adapter_config.json")
    cfg = {}
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            cfg = json.load(f)
    return sd, cfg


def _strip_adapter_key(key: str) -> str:
    """Normalize a PEFT key to the base-model key it targets."""
    k = re.sub(r"^base_model\.model\.", "", key)
    k = re.sub(r"\.lora_(A|B)(\.default)?\.weight$", ".lora_\\1", k)
    return k.replace("modules_to_save.default.", "").replace("modules_to_save.", "")


def split_adapter(sd: SD):
    """-> (lora_pairs {base_key: (A, B)}, full_replacements {base_key: W})."""
    pairs_a, pairs_b, full = {}, {}, {}
    for key, v in sd.items():
        norm = _strip_adapter_key(key)
        if norm.endswith(".lora_A"):
            pairs_a[norm[: -len(".lora_A")] + ".weight"] = v
        elif norm.endswith(".lora_B"):
            pairs_b[norm[: -len(".lora_B")] + ".weight"] = v
        else:
            full[norm] = v
    pairs = {k: (a, pairs_b[k]) for k, a in pairs_a.items() if k in pairs_b}
    return pairs, full


def _np_dtype(dtype: torch.dtype):
    """The numpy dtype the JAX package holds a tensor of ``dtype`` in (its
    reader widens bf16 to fp32)."""
    return {torch.bfloat16: np.float32, torch.float16: np.float16,
            torch.float64: np.float64}.get(dtype, np.float32)


class FoldingStateDict:
    """A base state dict whose changes are recorded per key and made only
    when a tensor is read: ``pop`` (or ``[]``) moves one base tensor to
    ``device`` and applies its resize, folds and replacements there, in the
    order they were recorded.  The unmerged loaders stream a 7B tower
    through it, so the tower is never held folded in full, on the host or
    on the card; ``shape`` gives a key's shape after its changes."""

    def __init__(self, sd: SD, device=None):
        self._base = dict(sd)
        self._ops: Dict[str, list] = {}
        self._shapes = {k: tuple(v.shape) for k, v in sd.items()}
        self._dtypes = {k: v.dtype for k, v in sd.items()}
        self.device = device

    def __contains__(self, key) -> bool:
        return key in self._base

    def __iter__(self):
        return iter(self._base)

    def __len__(self) -> int:
        return len(self._base)

    def shape(self, key: str) -> tuple:
        return self._shapes[key]

    def __getitem__(self, key: str) -> torch.Tensor:
        t = self._base[key]
        if self.device is not None:
            t = t.to(self.device)
        for op in self._ops.get(key, ()):
            t = op(t)
        return t

    def pop(self, key: str) -> torch.Tensor:
        t = self[key]
        del self._base[key]
        self._ops.pop(key, None)
        return t

    def materialize(self) -> SD:
        return {k: self[k] for k in self._base}

    def _record(self, key: str, op, shape: tuple) -> None:
        self._ops.setdefault(key, []).append(op)
        self._shapes[key] = shape

    def resize(self, new_vocab: int, initializer_range: float = 0.02, seed: int = 0,
               keys: Tuple[str, ...] = ("model.embed_tokens.weight", "lm_head.weight")) -> None:
        """Grow embedding / lm_head rows to ``new_vocab`` (HF resize
        semantics).  The new rows are drawn now, in key order, so they are
        the JAX package's whatever order the keys are read in later."""
        rng = np.random.default_rng(seed)
        for k in keys:
            if k not in self._base:
                continue
            rows, width = self._shapes[k]
            if rows >= new_vocab:
                continue
            dt = self._dtypes[k]
            extra = rng.normal(0.0, initializer_range, (new_vocab - rows, width))
            extra = torch.from_numpy(extra.astype(_np_dtype(dt))).to(dt)
            self._record(k, lambda t, e=extra: torch.cat([t, e.to(t.device, t.dtype)], dim=0),
                         (new_vocab, width))

    def fold(self, adapter_sd: SD, adapter_cfg: Optional[dict] = None, *,
             key_prefix: str = "") -> None:
        """Record an adapter's folds (``fold_pair``) and full replacements
        (``modules_to_save``); see ``fold_lora``."""
        cfg = adapter_cfg or {}
        scale, fifo = lora_scale(cfg), bool(cfg.get("fan_in_fan_out"))
        pairs, full = split_adapter(adapter_sd)
        applied = 0

        def base_key(k):
            return k[len(key_prefix):] if key_prefix and k.startswith(key_prefix) else k

        for k, (a, b) in pairs.items():
            bk = base_key(k)
            if bk in self._base:
                self._record(bk, lambda t, a=a, b=b: fold_pair(t, a, b, scale, fifo),
                             self._shapes[bk])
                applied += 1
        for k, w in full.items():
            bk = base_key(k)
            if bk in self._base:
                self._record(bk, lambda t, w=w: w.to(t.device, t.dtype), tuple(w.shape))
                applied += 1
        if applied == 0 and (pairs or full):
            raise ValueError(
                f"no adapter keys matched the base state dict (prefix={key_prefix!r}); "
                f"example adapter keys: {list(pairs)[:3] + list(full)[:3]}")


def resize_embeddings(
    base_sd: SD,
    new_vocab: int,
    initializer_range: float = 0.02,
    seed: int = 0,
    keys: Tuple[str, ...] = ("model.embed_tokens.weight", "lm_head.weight"),
) -> SD:
    """Grow embedding / lm_head rows to ``new_vocab`` (HF resize semantics);
    the new rows on each tensor's own device."""
    lazy = FoldingStateDict(base_sd)
    lazy.resize(new_vocab, initializer_range, seed, keys)
    return lazy.materialize()


def lora_scale(cfg: dict) -> float:
    """alpha / r, or alpha / sqrt(r) with ``use_rslora``."""
    alpha, r = float(cfg.get("lora_alpha", 1.0)), float(cfg.get("r", 1.0))
    return alpha / math.sqrt(r) if cfg.get("use_rslora") else alpha / r


def fold_pair(w: torch.Tensor, a: torch.Tensor, b: torch.Tensor, scale: float,
              fan_in_fan_out: bool = False) -> torch.Tensor:
    """``W + (B @ A) * scale`` in fp32 on W's device, returned in W's dtype."""
    delta = (b.to(w.device, torch.float32) @ a.to(w.device, torch.float32)) * scale
    if fan_in_fan_out:
        delta = delta.t()
    return (w.float() + delta).to(w.dtype)


def fold_lora(base_sd: SD, adapter_sd: SD, adapter_cfg: Optional[dict] = None, *,
              key_prefix: str = "") -> SD:
    """Fold an adapter into a base state dict (dense result).

    ``key_prefix`` maps adapter key space onto the base's: e.g. the composite
    VisualCLA adapter uses ``text_model.model.layers...`` while the standalone
    LLaMA base uses ``model.layers...`` — pass key_prefix="text_model."."""
    lazy = FoldingStateDict(base_sd)
    lazy.fold(adapter_sd, adapter_cfg, key_prefix=key_prefix)
    return lazy.materialize()


def partition_visualcla_adapter(adapter_sd: SD) -> Dict[str, SD]:
    """Split a composite VisualCLA adapter into per-component dicts (the
    webui conversion's split).  Keys keep their intra-component paths;
    vision keys keep their inner ``vision_model.`` prefix, the CLIP base's
    key space."""
    comp = {"text_model": {}, "vision_model": {}, "visual_resampler": {},
            "image_projection_layer": {}}
    for key, v in adapter_sd.items():
        norm = re.sub(r"^base_model\.model\.", "", key)
        for name in comp:
            if norm.startswith(name + "."):
                comp[name][norm[len(name) + 1:]] = v
                break
    return comp
