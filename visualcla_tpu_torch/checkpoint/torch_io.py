"""Readers for the reference's checkpoint containers (port of
visualcla_tpu/checkpoint/torch_io.py).

Every container the reference stack produces:
- ``pytorch_model.bin`` (torch pickle) and the reference's glob of
  ``pytorch_model*.bin`` files at a merged directory's root;
- HF sharded checkpoints through ``pytorch_model.bin.index.json`` or
  ``model.safetensors.index.json``;
- ``model.safetensors``, read by this package's own reader
  (``serialize.iter_safetensors``: no safetensors package needed);
- LoRA ``adapter_model.bin`` / ``adapter_model.safetensors``.

Tensors come back as CPU torch tensors in their stored dtype.  A pickle is
opened with ``mmap=True``, so its tensors are pages of the file until they
are used: a 13.5 GB text tower is not read twice into memory.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict

import torch

from .serialize import iter_safetensors


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """One checkpoint file (torch pickle or safetensors) -> {key: tensor}."""
    if path.endswith(".safetensors"):
        return dict(iter_safetensors(path))
    return dict(torch.load(path, map_location="cpu", weights_only=True, mmap=True))


def load_state_dict(model_dir: str) -> Dict[str, torch.Tensor]:
    """The full state dict of an HF-style model directory (any container)."""
    d = model_dir
    for index_name in ("pytorch_model.bin.index.json", "model.safetensors.index.json"):
        idx = os.path.join(d, index_name)
        if os.path.exists(idx):
            with open(idx) as f:
                weight_map = json.load(f)["weight_map"]
            out = {}
            for shard in sorted(set(weight_map.values())):
                out.update(load_file(os.path.join(d, shard)))
            return out
    for name in ("pytorch_model.bin", "model.safetensors", "adapter_model.bin",
                 "adapter_model.safetensors"):
        p = os.path.join(d, name)
        if os.path.exists(p):
            return load_file(p)
    ckpts = sorted(glob.glob(os.path.join(d, "pytorch_model*.bin")))
    if ckpts:
        out = {}
        for c in ckpts:
            out.update(load_file(c))
        return out
    raise FileNotFoundError(f"no checkpoint container found under {d}")
