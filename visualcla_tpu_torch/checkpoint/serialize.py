"""Native checkpoint I/O without the safetensors package (port of
visualcla_tpu/checkpoint/serialize.py).

A native checkpoint directory holds ``config.json`` (the composite config)
and ``params.safetensors``: an 8-byte little-endian header length, a JSON
header ``{key: {dtype, shape, data_offsets}}``, then the raw data.  Keys are
the JAX package's ``/``-joined tree paths (stacked layers, ``(in, out)``
matmul weights); ``checkpoint.from_jax`` maps them onto the modules.  BF16
is read as uint16 and viewed as ``torch.bfloat16``.  ``save_checkpoint``
writes the JAX package's format byte for byte: the same header, the same
dtype rules (``_leaf_target_dtype``) and the same ``config.json``.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from ..core.config import VisualCLAConfig

from ..ops.quantization import (INT8_TEXT_LEAVES, effective_group, quantize_grouped_np,
                                 quantize_np)
from .from_jax import as_torch, leaf_to_state, lora_specs, wrap_lora_

# safetensors dtype tag -> (numpy storage dtype, torch dtype)
_DTYPES = {
    "F64": (np.float64, torch.float64), "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16), "BF16": (np.uint16, torch.bfloat16),
    "I64": (np.int64, torch.int64), "I32": (np.int32, torch.int32),
    "I16": (np.int16, torch.int16), "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8), "BOOL": (np.bool_, torch.bool),
}
_TAGS = {t: tag for tag, (_, t) in _DTYPES.items()}


def read_header(path: str) -> Tuple[dict, int]:
    """(the JSON header, the data section's offset) of a safetensors file."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        return json.loads(f.read(n)), 8 + n


def iter_safetensors(path: str, prefixes=None) -> Iterator[Tuple[str, torch.Tensor]]:
    """Yield (key, CPU tensor) one leaf at a time from a mapped file; with
    ``prefixes``, only the leaves whose key starts with one of them are read."""
    header, offset = read_header(path)
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=offset)
    for key, meta in header.items():
        if key == "__metadata__" or (prefixes and not key.startswith(tuple(prefixes))):
            continue
        np_dtype, torch_dtype = _DTYPES[meta["dtype"]]
        start, end = meta["data_offsets"]
        arr = np.array(data[start:end].view(np_dtype)).reshape(meta["shape"])
        t = torch.from_numpy(arr)
        yield key, (t.view(torch_dtype) if torch_dtype == torch.bfloat16 else t)


READ_BYTES = [0]  # bytes copied out of mapped files by read_slice


def read_slice(path: str, key: str, index: tuple, header=None) -> torch.Tensor:
    """The slice ``index`` of leaf ``key`` of a mapped safetensors file: only
    those bytes are copied out of the map (counted in ``READ_BYTES``)."""
    if header is None:
        header = read_header(path)
    meta, offset = header[0][key], header[1]
    np_dtype, torch_dtype = _DTYPES[meta["dtype"]]
    start, end = meta["data_offsets"]
    view = np.memmap(path, dtype=np.uint8, mode="r", offset=offset + start,
                     shape=(end - start,)).view(np_dtype).reshape(meta["shape"])
    arr = np.array(view[index])
    READ_BYTES[0] += arr.nbytes
    t = torch.from_numpy(arr)
    return t.view(torch_dtype) if torch_dtype == torch.bfloat16 else t


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    return dict(iter_safetensors(path))


def write_safetensors(path: str, tensors: Dict[str, Any], dtype_of=None,
                      consume: bool = False) -> None:
    """Write tensors (or numpy arrays) in the format read above, one at a
    time: the header first, then each tensor moved to the host, converted to
    ``dtype_of(key, dtype)`` (default: its own dtype) and appended, so the
    peak is one converted tensor above the inputs.  ``consume=True`` pops
    each from ``tensors`` once written, so memory falls as the file grows."""
    flat = tensors if consume else dict(tensors)
    header, offset = {}, 0
    for key in flat:
        t = flat[key] = as_torch(flat[key])
        dt = dtype_of(key, t.dtype) if dtype_of else t.dtype
        n = t.numel() * dt.itemsize
        header[key] = {"dtype": _TAGS[dt], "shape": list(t.shape),
                       "data_offsets": [offset, offset + n]}
        offset += n
    hb = json.dumps(header).encode("utf-8")
    hb += b" " * (-len(hb) % 8)  # the data section starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(len(hb).to_bytes(8, "little"))
        f.write(hb)
        for key in list(header):
            t = flat.pop(key) if consume else flat[key]
            t = t.detach().to("cpu", dtype_of(key, t.dtype) if dtype_of else t.dtype)
            t = t.contiguous()
            (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tofile(f)
            del t


def flatten_tree(tree: dict, prefix: str = "") -> Dict[str, Any]:
    """Nested dict -> flat ``/``-joined keys, in the tree's order."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_tree(v, path))
        else:
            out[path] = v
    return out


def unflatten_tree(flat: Dict[str, Any]) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


_FLOATS = (torch.float64, torch.float32, torch.float16, torch.bfloat16)
TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
                "float32": torch.float32}


def _leaf_target_dtype(key: str, src: torch.dtype, target: torch.dtype) -> torch.dtype:
    """The JAX writer's rule: quantization scales stay as they are (fp32, the
    dequantization contract); floating leaves convert to ``target``;
    everything else passes through."""
    if key.endswith("/scale"):
        return src
    return target if src in _FLOATS else src


def save_checkpoint(out_dir: str, params: dict, cfg: VisualCLAConfig,
                    dtype: str = "bfloat16", consume: bool = False) -> None:
    """Write ``params`` (a nested or flat JAX-layout tree of CPU tensors or
    numpy arrays) as a native checkpoint, one leaf at a time: the header
    first, then each leaf converted and appended, so the peak is the tree
    plus one converted leaf.  ``consume=True`` drops each leaf from the tree
    once written, so memory falls over the save.  Floats convert with
    round-to-nearest-even (``Tensor.to``), as the JAX writer's ml_dtypes do."""
    os.makedirs(out_dir, exist_ok=True)
    flat = flatten_tree(params)
    if consume:
        params.clear()
    target = TORCH_DTYPES[dtype]
    write_safetensors(os.path.join(out_dir, "params.safetensors"), flat,
                      lambda key, src: _leaf_target_dtype(key, src, target), consume=consume)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(cfg.to_hf_dict(), f, indent=2)


def load_checkpoint(ckpt_dir: str, *, device=None, dtype=torch.bfloat16,
                    quantize: str = "none", mesh=None):
    """-> (VisualCLAModel on ``device`` in ``dtype``, VisualCLAConfig).  Leaves
    stream from the file one at a time straight into the module's tensors.

    ``quantize="int8"`` (the reference's load_in_8bit scope) or ``"int4"``
    quantizes the text tower on the host while it streams, one leading-axis
    slice at a time, as the JAX loader does: the layer matmuls and the LM
    head per output channel (int8) or grouped (int4, group
    ``effective_group(in)``), the embedding table per row (int8 at both
    tiers).  The dense original of a quantized leaf never reaches the device.

    ``mesh``: the model is built at this rank's shard shapes
    (``parallel.sharding``) and each leaf is read a layer at a time, only
    the rank's slice of it copied out of the map; a leaf quantized on load is
    read whole, quantized, then sliced (an int8 scale is the whole
    contraction's)."""
    from ..models.visualcla import VisualCLAModel

    check_quantize(quantize)
    cfg = VisualCLAConfig.from_pretrained(ckpt_dir)
    path = os.path.join(ckpt_dir, "params.safetensors")
    header, offset = read_header(path)
    shapes = {k: tuple(m["shape"]) for k, m in header.items() if k != "__metadata__"}
    model = VisualCLAModel(cfg, device="meta" if mesh is not None else device, dtype=dtype,
                           quant=quantize)
    wrap_lora_(model, lora_specs({k: (shapes[k], m["dtype"])
                                  for k, m in header.items() if k != "__metadata__"}))
    if mesh is None:
        placer = StatePlacer(model, cfg, quantize)
        for key, value in iter_safetensors(path):
            placer.put(key, value)
        placer.finish()
        return model, cfg
    from ..parallel import sharding, tp

    specs = sharding.materialize_local(model, mesh, device)
    if model.resampler is not None:
        model.resampler.head_mask.fill_(1.0)  # no pruned heads unless the file says so
    placer = StatePlacer(model, cfg, quantize, specs=specs, mesh=mesh)
    leaf = sharding.leaf_specs(shapes, mesh)
    for key, shape in shapes.items():
        if not cfg.use_visual_resampler and key.startswith("resampler/"):
            continue
        whole = quantize != "none" and key in INT8_TEXT_LEAVES
        stacked = len(key.split("/")) > 2 and key.split("/")[1] == "layers"
        spec = (None,) * len(shape) if whole else leaf[key]
        for l in (range(shape[0]) if stacked else [None]):
            idx = sharding.local_slice(spec[1:] if stacked else spec,
                                       shape[1:] if stacked else shape, mesh)
            placer.put(key, read_slice(path, key, ((l,) if stacked else ()) + idx,
                                       (header, offset)), layer=l)
    placer.finish()
    tp.attach(model, mesh, specs)
    return model, cfg


def check_quantize(quantize: str) -> None:
    if quantize not in ("none", "int8", "int4"):
        raise ValueError(f"quantize must be none/int8/int4, got {quantize!r}")


class StatePlacer:
    """Copies JAX leaves (whole stacked leaves, or one layer's slice with
    ``layer=``) into a model's tensors where they lie, quantizing the text
    tower's leaves on the host first at the int8 / int4 tier; ``finish``
    raises if a tensor of the model was never written."""

    def __init__(self, model, cfg: VisualCLAConfig, quantize: str = "none", *,
                 specs=None, mesh=None):
        check_quantize(quantize)
        self.state = model.state_dict()
        self.cfg, self.quantize = cfg, quantize
        self.specs, self.mesh = specs, mesh  # over a mesh: a whole leaf is sliced
        self.seen = set()

    def put(self, key: str, value, layer=None) -> None:
        if not self.cfg.use_visual_resampler and key.startswith("resampler/"):
            return
        if self.quantize != "none" and key in INT8_TEXT_LEAVES:
            for sub, arr in _quantize_leaf(key, value, self.quantize).items():
                self._copy(f"{key}/{sub}", arr, layer)
        else:
            self._copy(key, value, layer)

    def _copy(self, key, value, layer):
        for name, t in leaf_to_state(key, value, layer):
            if name not in self.state:
                raise KeyError(f"checkpoint leaf {key!r} maps to unknown {name!r}")
            if self.mesh is not None and tuple(t.shape) != tuple(self.state[name].shape):
                from ..parallel.sharding import local_slice

                t = t[local_slice(self.specs[name], tuple(t.shape), self.mesh)]
            self.state[name].copy_(t)
            self.seen.add(name)

    def finish(self) -> None:
        missing = sorted(set(self.state) - self.seen - {"resampler.head_mask"})
        if missing:
            raise KeyError(f"checkpoint lacks {missing[:5]} ({len(missing)} tensors)")


def _quantize_leaf(key: str, value: torch.Tensor, quantize: str) -> dict:
    """{"q", "scale"} numpy arrays of one text-tower leaf (stacked, or one
    layer's 2-D slice) at the given tier, quantized one leading-axis slice at
    a time into preallocated outputs."""
    eff = (effective_group(value.shape[-2])
           if quantize == "int4" and key != "text/embed_tokens" else None)
    if eff is not None:
        def fn(a):
            return quantize_grouped_np(a, group=eff)
    else:
        def fn(a, ax=INT8_TEXT_LEAVES[key]):
            return quantize_np(a, axis=ax)
    if value.dim() < 3:
        qd = fn(value.float().cpu().numpy())
        return {"q": qd["q"], "scale": qd["scale"]}
    out = {}
    for i in range(value.shape[0]):
        qd = fn(value[i].float().cpu().numpy())
        for name in ("q", "scale"):
            if i == 0:
                out[name] = np.empty((value.shape[0],) + qd[name].shape, qd[name].dtype)
            out[name][i] = qd[name]
    return out
