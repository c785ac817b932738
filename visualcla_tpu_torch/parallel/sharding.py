"""Partition rules of the (data, model) mesh (port of
visualcla_tpu/parallel/sharding.py).

The rule tables, their lookup and the validity rule are the JAX package's:
``data`` shards the batch (DP), ``model`` is Megatron-style tensor
parallelism (TP): attention heads and the MLP hidden on ``model``, the
row-parallel projections' partial sums summed over it.  A spec is a tuple of
axis names (None: replicated), keyed by the JAX leaf path, and it is what
``shard_params`` slices each of a model's tensors by.

The runtime is explicit SPMD over ``torch.distributed``: one process per
device, each holding plain local tensors (its own shard of every leaf), the
collectives written out in ``parallel.tp``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with dim names ``("data",
"model")`` (or ``("data", "seq")`` for context parallelism); it only builds
the process groups.  Every call on a meshed model runs on every rank with
the same arguments and returns the same result on every rank.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

DATA, MODEL = "data", "model"
Spec = Tuple[Optional[str], ...]


def _p(*axes) -> Spec:
    return tuple(axes)


def make_mesh(n_data: int = 1, n_model: Optional[int] = None, device_type: Optional[str] = None):
    """A (data, model) ``DeviceMesh`` over the world (``distributed.initialize``
    first).  Default: every rank on ``model`` (TP is the main strategy for
    a 7B model on one node); ``device_type`` defaults to ``cuda`` where the
    process group is NCCL, else ``cpu``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if n_model is None:
        n_model = world // n_data
    if n_data * n_model != world:
        raise ValueError(f"mesh ({n_data}, {n_model}) does not cover {world} ranks")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_data, n_model), mesh_dim_names=(DATA, MODEL))


def check_mesh(mesh) -> None:
    """Raise unless ``mesh`` is None or a ``DeviceMesh`` whose dims are among
    ("data", "model", "seq")."""
    if mesh is None:
        return
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh "
                        f"(parallel.sharding.make_mesh), got {type(mesh).__name__}")
    bad = set(mesh.mesh_dim_names or ()) - {DATA, MODEL, "seq"}
    if bad or not mesh.mesh_dim_names:
        raise ValueError(f"mesh dims must be among ('data', 'model', 'seq'), got "
                         f"{mesh.mesh_dim_names}")


def bind(model, mesh) -> None:
    """Check ``mesh`` and shard ``model`` over it unless it is already (an
    engine's constructor): raise if the model is sharded over another mesh,
    or if it is sharded and no mesh is given."""
    check_mesh(mesh)
    held = getattr(model, "mesh", None)
    if mesh is not None and held is None:
        shard_params(model, mesh)
    elif held is not mesh:
        raise ValueError("the model is sharded over another mesh than the one given "
                         "(pass the model's mesh)")


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (or of a mapping, as it is)."""
    if mesh is None:
        return {}
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


# ---------------------------------------------------------------------------
# parameter partition specs (path-based rules)
# ---------------------------------------------------------------------------

# LLaMA: layers are stacked with a leading layer axis (None in every spec).
_LLAMA_RULES = {
    "embed_tokens": _p(None, MODEL),        # (V, H): shard H (gathered per token)
    "lm_head": _p(None, MODEL),             # (H, V): shard V, logits gathered
    "final_norm": _p(),
    ("layers", "input_norm"): _p(),
    ("layers", "post_norm"): _p(),
    ("layers", "q_proj"): _p(None, None, MODEL),   # column-parallel
    ("layers", "k_proj"): _p(None, None, MODEL),
    ("layers", "v_proj"): _p(None, None, MODEL),
    ("layers", "o_proj"): _p(None, MODEL, None),   # row-parallel -> all_reduce
    ("layers", "gate_proj"): _p(None, None, MODEL),
    ("layers", "up_proj"): _p(None, None, MODEL),
    ("layers", "down_proj"): _p(None, MODEL, None),
}

# ViT: the same Megatron pattern; the column-parallel layers' biases shard on MODEL.
_VIT_RULES = {
    "class_embedding": _p(),
    "patch_embedding": _p(None, MODEL),
    "position_embedding": _p(None, MODEL),
    "pre_layernorm": _p(),
    "post_layernorm": _p(),
    ("layers", "ln1"): _p(),
    ("layers", "ln2"): _p(),
    ("layers", "q_proj"): _p(None, None, MODEL),
    ("layers", "q_bias"): _p(None, MODEL),
    ("layers", "k_proj"): _p(None, None, MODEL),
    ("layers", "k_bias"): _p(None, MODEL),
    ("layers", "v_proj"): _p(None, None, MODEL),
    ("layers", "v_bias"): _p(None, MODEL),
    ("layers", "o_proj"): _p(None, MODEL, None),
    ("layers", "o_bias"): _p(),
    ("layers", "fc1"): _p(None, None, MODEL),
    ("layers", "fc1_bias"): _p(None, MODEL),
    ("layers", "fc2"): _p(None, MODEL, None),
    ("layers", "fc2_bias"): _p(),
}

_RESAMPLER_RULES = {
    "query_embedding": _p(),
    "pooler": _p(),
    ("layers", "q_proj"): _p(None, None, MODEL),
    ("layers", "q_bias"): _p(None, MODEL),
    ("layers", "k_proj"): _p(None, None, MODEL),
    ("layers", "k_bias"): _p(None, MODEL),
    ("layers", "v_proj"): _p(None, None, MODEL),
    ("layers", "v_bias"): _p(None, MODEL),
    ("layers", "attn_out"): _p(None, MODEL, None),
    ("layers", "attn_out_bias"): _p(),
    ("layers", "attn_ln"): _p(),
    ("layers", "inter"): _p(None, None, MODEL),
    ("layers", "inter_bias"): _p(None, MODEL),
    ("layers", "out"): _p(None, MODEL, None),
    ("layers", "out_bias"): _p(),
    ("layers", "out_ln"): _p(),
}

_PROJECTION_RULES = {"weight": _p(None, MODEL), "bias": _p(MODEL)}


def _lookup(rules: dict, path: tuple) -> Spec:
    """Longest-prefix match of a param path against a rule table."""
    for depth in range(len(path), 0, -1):
        key = path[0] if depth == 1 else tuple(path[:depth])
        if key in rules:
            return rules[key]
    return _p()


def _tree_specs(tree, rules: dict, prefix=()) -> dict:
    out = {}
    for k, v in tree.items():
        path = prefix + (k,)
        if isinstance(v, dict):
            if (set(v.keys()) == {"q", "scale"}
                    and np.ndim(v["q"]) == np.ndim(v["scale"]) + 1):
                # a GROUPED quantized leaf: q (..., G, gs, out), scale (...,
                # G, out).  The base rule maps the original (..., in, out)
                # weight; the contraction's split (G, gs) carries the in-dim
                # axis on G, never on gs (a 'model'-divisible gs would shard
                # inside a group)
                base = tuple(_lookup(rules, path))
                base = base + (None,) * (np.ndim(v["scale"]) - len(base))
                out[k] = {"q": _p(*base[:-1], None, base[-1]), "scale": _p(*base)}
            else:
                out[k] = _tree_specs(v, rules, path)
        else:
            out[k] = _lookup(rules, path)
    return out


def param_specs(params: dict, fsdp: bool = False) -> dict:
    """The spec tree of a composite VisualCLA parameter tree (nested, JAX
    layout; leaves need only ``ndim``).

    ``fsdp=True`` also shards every stacked layer tensor's leading layer axis
    over ``data`` (ZeRO-style, for training; ``parallel.fsdp`` is its
    runtime)."""
    specs = {}
    if "text" in params:
        specs["text"] = _tree_specs(params["text"], _LLAMA_RULES)
    if "vision" in params:
        specs["vision"] = _tree_specs(params["vision"], _VIT_RULES)
    if "resampler" in params:
        specs["resampler"] = _tree_specs(params["resampler"], _RESAMPLER_RULES)
    if "projection" in params:
        specs["projection"] = dict(_PROJECTION_RULES)
    if "embed_tokens" in params:  # a standalone LLaMA tree
        specs = _tree_specs(params, _LLAMA_RULES)
    if fsdp:
        specs = _apply_fsdp(specs)
    return specs


def _apply_fsdp(specs, inside_layers: bool = False):
    out = {}
    for k, v in specs.items():
        if isinstance(v, dict):
            out[k] = _apply_fsdp(v, inside_layers or k == "layers")
        elif inside_layers:
            out[k] = _p(DATA, *tuple(v)[1:])  # the stacked tensors' leading (layer) axis
        else:
            out[k] = v
    return out


def _lookup_flat(flat_key: str) -> Spec:
    """The spec of a ``/``-joined checkpoint path (e.g. ``text/layers/q_proj``).
    Quantized leaves reuse their weight's spec (``.../q_proj/scale`` maps
    like ``.../q_proj``; ``_valid_spec`` clears the axes that do not divide)."""
    parts = [p for p in flat_key.split("/") if p not in ("q", "scale")]
    if not parts:
        return _p()
    comp, rest = parts[0], tuple(parts[1:])
    if comp == "text":
        return _lookup(_LLAMA_RULES, rest)
    if comp == "vision":
        return _lookup(_VIT_RULES, rest)
    if comp == "resampler":
        return _lookup(_RESAMPLER_RULES, rest)
    if comp == "projection":
        return _PROJECTION_RULES.get(rest[0] if rest else "", _p())
    return _lookup(_LLAMA_RULES, tuple(parts))  # a standalone LLaMA tree


def _valid_spec(spec: Spec, shape: tuple, mesh) -> Spec:
    """Clear the axes that do not divide their dim evenly, and those the mesh
    lacks (a ('data', 'seq') mesh has no 'model')."""
    sizes = mesh_shape(mesh)
    if len(spec) > len(shape):
        return _p()
    fixed = []
    for dim, axis in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if axis is None or axis not in sizes:
            fixed.append(None)
        else:
            fixed.append(axis if dim % sizes[axis] == 0 else None)
    while fixed and fixed[-1] is None:
        fixed.pop()
    return _p(*fixed)


def kv_cache_specs() -> dict:
    """KV cache (L, B, Nkv, S, hd): batch on data, heads on model; the int8
    cache's per-token-per-head scales (L, B, Nkv, S) alike."""
    kv = _p(None, DATA, MODEL, None, None)
    sc = _p(None, DATA, MODEL, None)
    return {"k": kv, "v": kv, "k_scale": sc, "v_scale": sc}


def batch_spec() -> Spec:
    return _p(DATA)


# ---------------------------------------------------------------------------
# a model's own tensors
# ---------------------------------------------------------------------------

def _shape_only(shape) -> np.ndarray:
    """A zero-byte stand-in with ``shape`` (the spec rules read only ndim)."""
    return np.broadcast_to(np.zeros((), np.bool_), tuple(shape))


def state_specs(model, mesh) -> Dict[str, Spec]:
    """{state name: valid spec over the module tensor's own axes} of a
    ``VisualCLAModel``: the JAX leaf's spec (``param_specs`` over the tree
    ``params_to_jax`` files the model as), cleared by ``_valid_spec`` on the
    stacked leaf's shape, without the layer axis, and reversed where the
    module stores the leaf transposed (torch's (out, in))."""
    from ..checkpoint.from_jax import _state_to_leaf

    state = model.state_dict()
    entries, leaves = {}, {}
    for name, t in state.items():
        if name == "resampler.head_mask":  # replicated (the rules have no entry)
            continue
        key, layer, t_jax = _state_to_leaf(name, t)
        if key is None:
            continue
        flipped = t.dim() == 2 and t_jax is not t  # stored as torch's (out, in)
        entries[name] = (key, layer, flipped)
        shape = tuple(t_jax.shape)
        if layer is None:
            leaves[key] = shape
        else:
            n = leaves.get(key, (0,))[0]
            leaves[key] = (max(n, layer + 1),) + shape
    specs = leaf_specs(leaves, mesh)
    out = {}
    for name, t in state.items():
        if name not in entries or name.rsplit(".", 1)[-1] in _LORA_LEAVES:
            out[name] = _p()  # LoRA's A and B stay whole (the JAX CLI adds them unsharded)
            continue
        key, layer, flipped = entries[name]
        spec = specs[key]
        if layer is not None:
            spec = spec[1:]
        spec = spec + (None,) * (t.dim() - len(spec))
        out[name] = spec[::-1] if flipped else spec
    return out


_LORA_LEAVES = ("lora_A", "lora_B", "lora_scale")


def local_slice(spec: Spec, shape: tuple, mesh) -> Tuple[slice, ...]:
    """This rank's index into a tensor of ``shape`` sharded by ``spec``."""
    sizes = mesh_shape(mesh)
    idx = []
    for dim, axis in zip(shape, spec):
        if axis is None:
            idx.append(slice(None))
        else:
            n, r = sizes[axis], mesh.get_local_rank(axis)
            w = dim // n
            idx.append(slice(r * w, (r + 1) * w))
    return tuple(idx)


def leaf_specs(shapes: Dict[str, tuple], mesh) -> Dict[str, Spec]:
    """{JAX leaf key: valid spec} of a flat tree given by its leaves' shapes
    (a checkpoint's header)."""
    from ..checkpoint.serialize import flatten_tree, unflatten_tree

    specs = flatten_tree(param_specs(unflatten_tree(
        {k: _shape_only(s) for k, s in shapes.items()})))
    return {k: tuple(_valid_spec(specs.get(k, _p()), shapes[k], mesh)) for k in shapes}


def local_shape(spec: Spec, shape: tuple, mesh) -> tuple:
    sizes = mesh_shape(mesh)
    return tuple(d // sizes[a] if a is not None else d
                 for d, a in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))))


def _set_tensor(model, name: str, t: torch.Tensor) -> None:
    """Replace the parameter or buffer ``name`` of ``model`` by ``t``."""
    owner, _, attr = name.rpartition(".")
    mod = model.get_submodule(owner) if owner else model
    if attr in mod._buffers:
        mod._buffers[attr] = t
    else:
        setattr(mod, attr, torch.nn.Parameter(t, requires_grad=False))


def materialize_local(model, mesh, device) -> Dict[str, Spec]:
    """Give a model built on ``meta`` its rank's tensors (uninitialised, at
    their local shapes by ``state_specs``) on ``device`` -> the specs."""
    specs = state_specs(model, mesh)
    for name, t in list(model.state_dict(keep_vars=True).items()):
        shape = local_shape(specs.get(name, _p()), tuple(t.shape), mesh)
        _set_tensor(model, name, torch.empty(shape, dtype=t.dtype, device=device))
    return specs


@torch.no_grad()
def slice_tensors(model, specs: Dict[str, Spec], mesh) -> None:
    """Cut each of ``model``'s tensors to this rank's shard by ``specs``, in
    place."""
    tensors = dict(model.named_parameters())
    tensors.update(dict(model.named_buffers()))
    for name, spec in specs.items():
        if any(spec):
            t = tensors[name]
            t.data = t.data[local_slice(spec, tuple(t.shape), mesh)].clone()


@torch.no_grad()
def shard_params(model, mesh, fsdp: bool = False):
    """Slice each of ``model``'s tensors to this rank's shard, in place, by
    ``state_specs``, and set up the model's collectives
    (``parallel.tp.attach``): the leaf's actual spec decides each one.  Axes
    that do not divide stay replicated, as ``_valid_spec`` says.  ``fsdp``
    then shards every layer stack's layer axis over ``data``
    (``parallel.fsdp.shard_layers``).  -> ``model``."""
    from . import tp

    model.text.require("mesh")
    specs = state_specs(model, mesh)
    slice_tensors(model, specs, mesh)
    tp.attach(model, mesh, specs)
    if fsdp:
        from .fsdp import shard_layers

        shard_layers(model, mesh)
    return model


# ---------------------------------------------------------------------------
# a parameter's placement: whole tensors from shards and back
# ---------------------------------------------------------------------------
#
# ``tp.attach`` marks a model-sharded parameter ``p.shard = (model Axis, dim)``;
# ``fsdp.shard_layers`` and ``pipeline.shard_text_params`` mark a parameter
# that one rank of an axis holds ``p.owner = (Axis, rank, its shape)``, the
# other ranks of that axis holding an empty tensor in its place.


def is_placed(p: torch.Tensor) -> bool:
    """True if ``p`` is sharded over ``model`` or held by one rank of an axis."""
    return hasattr(p, "shard") or hasattr(p, "owner")


def held(p: torch.Tensor) -> bool:
    """True unless ``p`` is held by another rank of its owner axis."""
    owner = getattr(p, "owner", None)
    return owner is None or owner[0].rank == owner[1]


def norm_axes(p: torch.Tensor) -> tuple:
    """The axes over which ``p``'s pieces make the logical array."""
    axes = []
    if hasattr(p, "shard"):
        axes.append(p.shard[0])
    if hasattr(p, "owner"):
        axes.append(p.owner[0])
    return tuple(axes)


@torch.no_grad()
def gather_whole(p: torch.Tensor, t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The logical (whole) tensor of ``t`` (default ``p`` itself; else a
    tensor placed as ``p`` is, such as its optimizer moments) on every rank:
    broadcast from its owner, then gathered over ``model``.  Every rank calls
    it for the same parameters in the same order."""
    from . import tp

    t = p.detach() if t is None else t
    owner = getattr(p, "owner", None)
    if owner is not None:
        ax, r, shape = owner
        buf = t.clone() if ax.rank == r else torch.empty(shape, dtype=t.dtype, device=t.device)
        t = tp.broadcast(buf, ax.group, r)
    shard = getattr(p, "shard", None)
    if shard is not None:
        ax, dim = shard
        t = tp.gather_from_model(t, ax.group, ax.size, dim)
    return t


def take_local(p: torch.Tensor, whole: torch.Tensor) -> torch.Tensor:
    """This rank's piece of ``whole`` placed as ``p`` (an empty tensor where
    another rank holds it)."""
    if not held(p):
        return whole.new_empty(0)
    shard = getattr(p, "shard", None)
    if shard is not None:
        ax, dim = shard
        w = whole.shape[dim] // ax.size
        whole = whole.narrow(dim, ax.rank * w, w)
    return whole
