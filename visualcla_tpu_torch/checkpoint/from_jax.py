"""The JAX package's parameter tree <-> this package's module state.

The JAX tree is flat ``/``-joined keys (``checkpoint.serialize.flatten_tree``)
with per-layer leaves stacked on a leading (L, ...) axis and matmul weights
stored ``(in, out)``.  Here each stacked leaf becomes L per-layer tensors
under ``<tower>.layers.<l>.``, each matmul weight is transposed to torch's
``(out, in)``, and each ``<name>_bias`` leaf becomes ``<name>.bias``.  The
native checkpoint loader, the reference-layout loaders (one layer's slice at
a time, ``layer=``) and the parity tests go through ``leaf_to_state``;
``params_to_jax`` is its inverse, for saving and exporting what a model holds.

Quantized text-tower leaves are ``<leaf>/q`` and ``<leaf>/scale``
(``ops.quantization``) and map onto ``<module>.q`` / ``<module>.scale``: an
int8 ``q`` (in, out) is transposed like a dense weight; the int4 carrier
(G, gs/2, out) uint8, every scale, and the embedding table's int8 rows keep
the JAX orientation.  A LoRA leaf ``{"w", "lora_A", "lora_B", "lora_scale"}``
of a layer linear maps onto a ``LoraLinear``: ``w`` (dense or quantized) to
``<module>.base``, A (in, r) and B (r, out) transposed to ``lora_A`` (r, in)
and ``lora_B`` (out, r), the per-layer scale to ``lora_scale``;
``wrap_lora_`` puts those modules in place before the state loads.  The
QLoRA tree (int8 layer matmuls under a float ``embed_tokens`` and
``lm_head``, which train) builds with ``head_tier``'s float head.
``params_to_jax(..., grads=True)`` maps a model's ``.grad``s the same way,
and ``jax_key`` names the JAX leaf a state entry belongs to (the training
predicates read those paths).
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core.config import VisualCLAConfig

from ..ops.linear import Int4Linear, Int8Linear, Linear, LoraLinear, base_features
from ..ops.quantization import effective_group

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
_BIAS_OF = {tower: {b: w for w, b in lin.items() if b} for tower, lin in _LAYER_LINEARS.items()}
_TEXT_NORMS = ("input_norm", "post_norm", "final_norm")
# (in, out) matmul leaves outside the layer stacks, and their module state names
_TOP_LINEARS = {"vision/patch_embedding": "vision.patch_embedding.weight",
                "projection/weight": "projection.weight",
                "text/lm_head": "text.lm_head.weight",
                "resampler/pooler/weight": "resampler.pooler.weight"}
_LORA = ("lora_A", "lora_B", "lora_scale")


def as_torch(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    return torch.from_numpy(arr if arr.flags.writeable else arr.copy())


def _quantized(kind: str, t: torch.Tensor, table: bool = False) -> torch.Tensor:
    """A q / scale leaf in the module's orientation: a per-channel int8 matmul
    weight (in, out) -> (out, in); carriers, scales and the table as they are."""
    return t.t() if kind == "q" and t.dtype == torch.int8 and not table else t


def _layer_state(tower: str, rest, l: int, t: torch.Tensor) -> Iterator[Tuple[str, torch.Tensor]]:
    """One layer's slice ``t`` of the stacked leaf ``<tower>/layers/<rest>``."""
    name, sub = rest[0], rest[1:]
    prefix = f"{tower}.layers.{l}.{name}"
    if sub and sub[0] in _LORA:  # lora_A (in, r) / lora_B (r, out): torch orientation
        yield f"{prefix}.{sub[0]}", (t if sub[0] == "lora_scale" else t.t())
    elif sub and sub[0] == "w":  # a LoRA leaf's frozen base
        if sub[1:]:
            if tower != "text":
                raise ValueError(f"{tower}/layers/{'/'.join(rest)}: only the text tower is "
                                 "quantized")
            yield f"{prefix}.base.{sub[1]}", _quantized(sub[1], t)
        else:
            yield f"{prefix}.base.weight", t.t()
    elif sub and sub[-1] in ("q", "scale"):
        if tower != "text":
            raise ValueError(f"{tower}/layers/{'/'.join(rest)}: only the text tower is quantized")
        yield f"{prefix}.{sub[-1]}", _quantized(sub[-1], t)
    elif name in _LAYER_LINEARS[tower]:
        yield prefix + ".weight", t.t()
    elif name in _BIAS_OF[tower]:
        yield f"{tower}.layers.{l}.{_BIAS_OF[tower][name]}.bias", t
    elif tower == "text" and name in _TEXT_NORMS:
        yield prefix + ".weight", t
    else:  # layer norms: <ln>/weight, <ln>/bias
        yield ".".join([prefix] + list(sub)), t


def leaf_to_state(key: str, value, layer: Optional[int] = None
                  ) -> Iterator[Tuple[str, torch.Tensor]]:
    """Map one JAX leaf to (state key, tensor) pairs of ``VisualCLAModel``.
    With ``layer``, ``value`` is that layer's slice of a stacked leaf."""
    parts = key.split("/")
    t = as_torch(value)
    tower = parts[0]
    if len(parts) > 2 and parts[1] == "layers":
        slices = [(layer, t)] if layer is not None else [(l, t[l]) for l in range(t.shape[0])]
        for l, tl in slices:
            yield from _layer_state(tower, parts[2:], l, tl)
        return
    if any(p in _LORA or p == "w" for p in parts[1:]):
        raise ValueError(f"leaf {key!r}: LoRA leaves are supported on layer linears only")
    if parts[-1] in ("q", "scale"):
        if tower != "text":
            raise ValueError(f"leaf {key!r}: only the text tower is quantized")
        yield f"text.{parts[1]}.{parts[-1]}", _quantized(parts[-1], t, parts[1] == "embed_tokens")
    elif key in _TOP_LINEARS:
        yield _TOP_LINEARS[key], t.t()
    elif tower == "text" and parts[-1] in _TEXT_NORMS:
        yield key.replace("/", ".") + ".weight", t
    else:
        yield key.replace("/", "."), t


def weight_tier(flat: Dict[str, object]) -> str:
    """The text tower's weight tier of a flat JAX tree: "int4" when any
    carrier is uint8, "int8" when any leaf is quantized, else "none"."""
    qs = [np.asarray(v).dtype if not isinstance(v, torch.Tensor) else v.dtype
          for k, v in flat.items() if k.endswith("/q")]
    if any(dt in (np.uint8, torch.uint8) for dt in qs):
        return "int4"
    return "int8" if qs else "none"


def head_tier(flat: Dict[str, object]) -> str:
    """The tier of the text tower's ``embed_tokens`` and ``lm_head``: "none"
    when both are float (the QLoRA tree), else ``weight_tier``'s."""
    floats = {k for k in ("text/embed_tokens", "text/lm_head") if k in flat}
    if len(floats) == 1:
        raise ValueError(f"{floats.pop()} is float and the other of embed_tokens / lm_head "
                         "is quantized: the two share one tier")
    return "none" if floats else weight_tier(flat)


def lora_specs(shapes: Dict[str, Tuple[tuple, object]]) -> Dict[str, dict]:
    """The LoRA-wrapped layer linears of a flat JAX tree, given each leaf's
    (shape, dtype): {"<tower>/layers/<name>": {"rank", "base": "dense" |
    "int8" | "int4"}}."""
    specs = {}
    for key, (shape, _) in shapes.items():
        if not key.endswith("/lora_A"):
            continue
        mod = key[:-len("/lora_A")]
        parts = mod.split("/")
        if len(parts) != 3 or parts[1] != "layers":
            raise ValueError(f"leaf {key!r}: LoRA leaves are supported on layer linears only")
        q = shapes.get(mod + "/w/q")
        base = "dense" if q is None else ("int4" if len(q[0]) == 4 else "int8")
        specs[mod] = {"rank": int(shape[-1]), "base": base}
    return specs


@torch.no_grad()
def wrap_lora_(model: nn.Module, specs: Dict[str, dict], dtype=None) -> nn.Module:
    """Replace each LoRA-wrapped layer linear of ``model`` (``lora_specs``)
    by a ``LoraLinear`` (A, B in ``dtype``, default the model's float dtype)
    over a base of the leaf's tier, in place: the linear itself when it is of
    that tier, else a new one whose values come from the state load; the
    linear's bias moves to the wrapper.  Over a mesh the wrapper runs as its
    base's spec says, and A and B are whole."""
    if dtype is None:
        dtype = model.projection.weight.dtype  # the model's float dtype at every tier
    kinds = {"dense": Linear, "int8": Int8Linear, "int4": Int4Linear}
    for mod, spec in specs.items():
        tower, _, name = mod.split("/")
        for layer in getattr(model, tower).layers:
            old = getattr(layer, name)
            dev = (old.q if hasattr(old, "q") else old.weight).device
            in_f, out_f = base_features(old)
            bias = getattr(old, "bias", None)
            if isinstance(old, kinds[spec["base"]]):
                base = old
                if bias is not None:
                    old.bias = None
            elif spec["base"] == "dense":
                base = Linear(in_f, out_f, False, device=dev, dtype=model.projection.weight.dtype)
            elif spec["base"] == "int8":
                base = Int8Linear(in_f, out_f, device=dev)
            else:
                base = Int4Linear(in_f, out_f, effective_group(in_f), device=dev)
            wrapped = LoraLinear(base, spec["rank"], bias=bias, device=dev, dtype=dtype)
            if hasattr(old, "tp"):  # over a mesh: the base's spec (parallel.tp.attach)
                wrapped.tp, wrapped.tp_in, wrapped.tp_out = old.tp, old.tp_in, old.tp_out
            setattr(layer, name, wrapped)
    return model


def _shapes(flat: Dict[str, object]) -> Dict[str, Tuple[tuple, object]]:
    out = {}
    for k, v in flat.items():
        t = v if isinstance(v, torch.Tensor) else np.asarray(v)
        out[k] = (tuple(t.shape), t.dtype)
    return out


def params_from_jax(flat: Dict[str, object], cfg: VisualCLAConfig,
                    specs: Optional[Dict[str, tuple]] = None, mesh=None
                    ) -> Dict[str, torch.Tensor]:
    """Flat JAX params (numpy arrays or CPU tensors) -> the state dict of a
    ``VisualCLAModel(cfg)`` (with ``wrap_lora_(model, lora_specs(...))``
    applied when the tree holds LoRA leaves).  With ``mesh`` and the model's
    ``specs`` (``parallel.sharding.state_specs``): each tensor is this
    rank's slice, cut from the numpy leaf before anything is copied."""
    from ..parallel.sharding import local_slice

    state: Dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        if not cfg.use_visual_resampler and key.startswith("resampler/"):
            continue
        for name, t in leaf_to_state(key, value):
            if mesh is not None and any(specs.get(name, ())):
                t = t[local_slice(specs[name], tuple(t.shape), mesh)]
            state[name] = t
    if cfg.use_visual_resampler and "resampler.head_mask" not in state:
        rcfg = cfg.visual_resampler_config  # no pruned heads: all ones
        state["resampler.head_mask"] = torch.ones(rcfg.num_hidden_layers,
                                                  rcfg.num_attention_heads)
    return state


def build_model(flat: Dict[str, object], cfg: VisualCLAConfig, *, device, dtype,
                towers: bool = False, mesh=None) -> nn.Module:
    """A ``VisualCLAModel`` (or ``VisionTowers`` with ``towers``) at the tree's
    weight tier with its LoRA wrappers, loaded from the flat JAX tree.  With
    ``mesh`` the model holds this rank's shards only (built at their shapes,
    each cut from the JAX leaf on the host) and is set up to run over the
    mesh."""
    from ..models.visualcla import VisionTowers, VisualCLAModel

    at = "meta" if mesh is not None else device
    if towers:
        model = VisionTowers(cfg, device=at, dtype=dtype)
    else:
        model = VisualCLAModel(cfg, device=at, dtype=dtype, quant=weight_tier(flat),
                               head_quant=head_tier(flat))
    wrap_lora_(model, lora_specs(_shapes(flat)))
    if mesh is None:
        model.load_state_dict(params_from_jax(flat, cfg))
        return model
    from ..parallel import sharding, tp

    specs = sharding.materialize_local(model, mesh, device)
    model.load_state_dict(params_from_jax(flat, cfg, specs, mesh))
    tp.attach(model, mesh, specs)
    return model


# ---------------------------------------------------------------------------
# module state -> the JAX tree
# ---------------------------------------------------------------------------

_STATE_TOP = {v: k for k, v in _TOP_LINEARS.items()}
_TOWER_ORDER = ("text", "vision", "projection", "resampler")


def _state_to_leaf(name: str, t: torch.Tensor):
    """(JAX leaf key, layer or None, tensor in the JAX orientation) of one
    state entry; (None, ...) for an all-ones head mask (no pruned heads)."""
    parts = name.split(".")
    tower = parts[0]
    if len(parts) > 3 and parts[1] == "layers":
        l, mod, sub = int(parts[2]), parts[3], parts[4:]
        key = f"{tower}/layers/{mod}"
        if sub[0] in _LORA:
            return f"{key}/{sub[0]}", l, (t if sub[0] == "lora_scale" else t.t())
        if sub[0] == "base":
            if sub[1] == "weight":
                return f"{key}/w", l, t.t()
            return f"{key}/w/{sub[1]}", l, _quantized(sub[1], t)
        if sub[0] in ("q", "scale"):
            return f"{key}/{sub[0]}", l, _quantized(sub[0], t)
        if mod in _LAYER_LINEARS[tower]:
            if sub[0] == "weight":
                return key, l, t.t()
            return f"{tower}/layers/{_LAYER_LINEARS[tower][mod]}", l, t
        if tower == "text" and mod in _TEXT_NORMS:
            return key, l, t
        return "/".join([key] + sub), l, t
    if name in _STATE_TOP:
        return _STATE_TOP[name], None, t.t()
    if name == "resampler.head_mask":
        return (None, None, t) if bool((t == 1).all()) else ("resampler/head_mask", None, t)
    if tower == "text" and parts[1] in ("embed_tokens", "lm_head") and len(parts) == 3:
        return f"text/{parts[1]}/{parts[2]}", None, _quantized(parts[2], t,
                                                                parts[1] == "embed_tokens")
    if tower == "text" and parts[1] == "final_norm":
        return "text/final_norm", None, t
    return name.replace(".", "/"), None, t


def jax_key(name: str) -> Optional[str]:
    """The JAX leaf key (``/``-joined path) of a module state entry, as
    ``params_to_jax`` files it (None: an all-ones head mask)."""
    return _state_to_leaf(name, torch.zeros(()))[0]


@torch.no_grad()
def params_to_jax(model: nn.Module, stack: bool = True, grads: bool = False
                  ) -> Dict[str, object]:
    """The inverse of ``params_from_jax``: a model's state as the JAX
    package's flat tree (stacked layers, ``(in, out)`` matmul weights), CPU
    tensors in the model's dtypes, towers in the JAX checkpoint's order.
    ``stack=False``: each layer leaf is the list of its layers' views of the
    model's own tensors, where they lie (nothing is copied).  ``grads=True``:
    the parameters' ``.grad``s in the same layout instead (the parameters
    without one are left out).  Over a mesh (``parallel.sharding``) the
    tensors are the whole ones, assembled from the ranks' pieces: every rank
    calls it."""
    from ..parallel.sharding import gather_whole, is_placed

    leaves: Dict[str, object] = {}
    if grads:
        entries = ((n, p.grad) for n, p in model.named_parameters() if p.grad is not None)
    else:
        entries = model.state_dict().items()
        named = dict(model.named_parameters())
        if any(is_placed(p) for p in named.values()):
            entries = [(n, gather_whole(named[n]) if n in named and is_placed(named[n]) else t)
                       for n, t in entries]
    for name, t in entries:
        key, layer, t = _state_to_leaf(name, t)
        if key is None:
            continue
        if layer is None:
            leaves[key] = t
        else:
            leaves.setdefault(key, []).append(t)
    flat = {}
    for tower in _TOWER_ORDER:
        for key, v in leaves.items():
            if key.split("/")[0] == tower:
                if not stack:
                    flat[key] = v
                else:
                    flat[key] = (torch.stack(v) if isinstance(v, list) else v).detach().cpu()
    return flat
