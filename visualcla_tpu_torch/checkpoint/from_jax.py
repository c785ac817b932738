"""The JAX package's parameter tree -> this package's module state.

The JAX tree is flat ``/``-joined keys (``visualcla_tpu.checkpoint.
serialize.flatten_tree``) with per-layer leaves stacked on a leading (L, ...)
axis and matmul weights stored ``(in, out)``.  Here each stacked leaf becomes
L per-layer tensors under ``<tower>.layers.<l>.``, each matmul weight is
transposed to torch's ``(out, in)``, and each ``<name>_bias`` leaf becomes
``<name>.bias``.  The native checkpoint loader and the parity tests (which
hand both packages the same weights) go through here.

Quantized text-tower leaves are ``<leaf>/q`` and ``<leaf>/scale``
(``ops.quantization``) and map onto ``<module>.q`` / ``<module>.scale``: an
int8 ``q`` (in, out) is transposed like a dense weight; the int4 carrier
(G, gs/2, out) uint8, every scale, and the embedding table's int8 rows keep
the JAX orientation.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from ..core.config import VisualCLAConfig

# matmul weight leaf -> its bias leaf (None: no bias), per tower
_LAYER_LINEARS = {
    "vision": {"q_proj": "q_bias", "k_proj": "k_bias", "v_proj": "v_bias",
               "o_proj": "o_bias", "fc1": "fc1_bias", "fc2": "fc2_bias"},
    "resampler": {"q_proj": "q_bias", "k_proj": "k_bias", "v_proj": "v_bias",
                  "attn_out": "attn_out_bias", "inter": "inter_bias",
                  "out": "out_bias"},
    "text": {"q_proj": None, "k_proj": None, "v_proj": None, "o_proj": None,
             "gate_proj": None, "up_proj": None, "down_proj": None},
}
_TEXT_NORMS = ("input_norm", "post_norm", "final_norm")
# (in, out) matmul leaves outside the layer stacks
_TOP_LINEARS = ("vision/patch_embedding", "projection/weight", "text/lm_head",
                "resampler/pooler/weight")


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    return torch.from_numpy(arr if arr.flags.writeable else arr.copy())


def _quantized_leaf(parts, t):
    """(state suffix, tensor) of one layer's (or one top leaf's) q / scale."""
    kind = parts[-1]
    if kind == "q" and t.dtype == torch.int8 and parts[-2] != "embed_tokens":
        return "q", t.t()  # per-channel int8 matmul weight: (in, out) -> (out, in)
    return kind, t


def leaf_to_state(key: str, value) -> Iterator[Tuple[str, torch.Tensor]]:
    """Map one JAX leaf to (state key, tensor) pairs of ``VisualCLAModel``."""
    parts = key.split("/")
    if any(p.startswith("lora_") for p in parts):
        raise NotImplementedError(
            f"leaf {key!r}: LoRA leaves are not ported yet (ROADMAP, open item 9: "
            "checkpoint conversion)")
    t = _tensor(value)
    tower = parts[0]
    if parts[-1] in ("q", "scale"):
        if tower != "text":
            raise ValueError(f"leaf {key!r}: only the text tower is quantized")
        if len(parts) > 3 and parts[1] == "layers":
            for l in range(t.shape[0]):
                suffix, tl = _quantized_leaf(parts, t[l])
                yield f"text.layers.{l}.{parts[2]}.{suffix}", tl
        else:
            suffix, tt = _quantized_leaf(parts, t)
            yield f"text.{parts[1]}.{suffix}", tt
        return
    if len(parts) > 2 and parts[1] == "layers":
        name, rest = parts[2], parts[3:]
        bias_of = {b: w for w, b in _LAYER_LINEARS[tower].items() if b}
        for l in range(t.shape[0]):
            prefix = f"{tower}.layers.{l}."
            if name in _LAYER_LINEARS[tower]:
                yield prefix + name + ".weight", t[l].t()
            elif name in bias_of:
                yield prefix + bias_of[name] + ".bias", t[l]
            elif tower == "text" and name in _TEXT_NORMS:
                yield prefix + name + ".weight", t[l]
            else:  # layer norms: <ln>/weight, <ln>/bias
                yield prefix + ".".join([name] + rest), t[l]
        return
    if key in _TOP_LINEARS:
        port = {"vision/patch_embedding": "vision.patch_embedding.weight",
                "text/lm_head": "text.lm_head.weight"}.get(key, key.replace("/", "."))
        yield port, t.t()
    elif tower == "text" and parts[-1] in _TEXT_NORMS:
        yield key.replace("/", ".") + ".weight", t
    else:
        yield key.replace("/", "."), t


def weight_tier(flat: Dict[str, object]) -> str:
    """The text tower's weight tier of a flat JAX tree: "int4" when any
    carrier is uint8, "int8" when any leaf is quantized, else "none"."""
    qs = [np.asarray(v).dtype for k, v in flat.items() if k.endswith("/q")]
    if any(dt == np.uint8 for dt in qs):
        return "int4"
    return "int8" if qs else "none"


def params_from_jax(flat: Dict[str, object], cfg: VisualCLAConfig) -> Dict[str, torch.Tensor]:
    """Flat JAX params (numpy arrays or CPU tensors) -> the state dict of a
    ``VisualCLAModel(cfg)``."""
    state: Dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        if not cfg.use_visual_resampler and key.startswith("resampler/"):
            continue
        state.update(leaf_to_state(key, value))
    if cfg.use_visual_resampler and "resampler.head_mask" not in state:
        rcfg = cfg.visual_resampler_config  # no pruned heads: all ones
        state["resampler.head_mask"] = torch.ones(rcfg.num_hidden_layers,
                                                  rcfg.num_attention_heads)
    return state
