"""Native checkpoint I/O without the safetensors package (port of
visualcla_tpu/checkpoint/serialize.py).

A native checkpoint directory holds ``config.json`` (the composite config)
and ``params.safetensors``: an 8-byte little-endian header length, a JSON
header ``{key: {dtype, shape, data_offsets}}``, then the raw data.  Keys are
the JAX package's ``/``-joined tree paths (stacked layers, ``(in, out)``
matmul weights); ``checkpoint.from_jax`` maps them onto the modules.  BF16
is read as uint16 and viewed as ``torch.bfloat16``.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from visualcla_tpu.core.config import VisualCLAConfig

from .from_jax import leaf_to_state

# safetensors dtype tag -> (numpy storage dtype, torch dtype)
_DTYPES = {
    "F64": (np.float64, torch.float64), "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16), "BF16": (np.uint16, torch.bfloat16),
    "I64": (np.int64, torch.int64), "I32": (np.int32, torch.int32),
    "I16": (np.int16, torch.int16), "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8), "BOOL": (np.bool_, torch.bool),
}
_TAGS = {t: tag for tag, (_, t) in _DTYPES.items()}


def iter_safetensors(path: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """Yield (key, CPU tensor) one leaf at a time from a mapped file."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n)
    for key, meta in header.items():
        if key == "__metadata__":
            continue
        np_dtype, torch_dtype = _DTYPES[meta["dtype"]]
        start, end = meta["data_offsets"]
        arr = np.array(data[start:end].view(np_dtype)).reshape(meta["shape"])
        t = torch.from_numpy(arr)
        yield key, (t.view(torch_dtype) if torch_dtype == torch.bfloat16 else t)


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    return dict(iter_safetensors(path))


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor]) -> None:
    """Write CPU tensors (or numpy arrays) in the format read above."""
    header, chunks, offset = {}, [], 0
    for key, t in tensors.items():
        t = torch.as_tensor(t).detach().cpu().contiguous()
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()
        header[key] = {"dtype": _TAGS[t.dtype], "shape": list(t.shape),
                       "data_offsets": [offset, offset + len(raw)]}
        chunks.append(raw)
        offset += len(raw)
    hb = json.dumps(header).encode("utf-8")
    hb += b" " * (-len(hb) % 8)
    with open(path, "wb") as f:
        f.write(len(hb).to_bytes(8, "little"))
        f.write(hb)
        for raw in chunks:
            f.write(raw)


def load_checkpoint(ckpt_dir: str, *, device=None, dtype=torch.bfloat16,
                    quantize: str = "none"):
    """-> (VisualCLAModel on ``device`` in ``dtype``, VisualCLAConfig).  Leaves
    stream from the file one at a time straight into the module's tensors."""
    from ..models.visualcla import VisualCLAModel

    if quantize != "none":
        raise NotImplementedError(
            f"quantize={quantize!r} is not ported yet (ROADMAP, open item 1: "
            "quantized tiers)")
    cfg = VisualCLAConfig.from_pretrained(ckpt_dir)
    model = VisualCLAModel(cfg, device=device, dtype=dtype)
    state = model.state_dict()
    seen = set()
    for key, value in iter_safetensors(os.path.join(ckpt_dir, "params.safetensors")):
        if not cfg.use_visual_resampler and key.startswith("resampler/"):
            continue
        for name, t in leaf_to_state(key, value):
            if name not in state:
                raise KeyError(f"checkpoint leaf {key!r} maps to unknown {name!r}")
            state[name].copy_(t)
            seen.add(name)
    missing = sorted(set(state) - seen - {"resampler.head_mask"})
    if missing:
        raise KeyError(f"checkpoint lacks {missing[:5]} ({len(missing)} tensors)")
    return model, cfg
