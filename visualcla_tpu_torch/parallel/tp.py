"""The port's collectives, and the tensor-parallel forms of its layers.

Each collective is a plain function of a tensor and a process group, and
none is skipped at group size 1: a mesh of one device still runs them (on
the card, NCCL kernels inside the captured graphs).

- ``reduce_from_model``: the sum of a row-parallel product's partial
  outputs (``all_reduce``);
- ``gather_from_model``: a column-sharded output's slices, concatenated on
  the last axis (``all_gather``);
- ``gather_rows_from_data``: each data rank's rows, stacked (``all_gather``
  on axis 0);
- ``ring_pass``: one hop of the context-parallel ring (``batch_isend_irecv``:
  send to the next seq rank, receive from the previous one).

``attach`` sets up a model whose tensors ``sharding.shard_params`` sliced:
each linear learns from its weight's actual spec whether its input
(row-parallel: the partial outputs are summed, the bias added once after
the sum) or its output (column-parallel: the rank's columns) is sharded;
``linear`` then applies the one rule: a sharded input that the weight needs
whole is gathered first, a whole input that the weight holds rows of is
sliced, and a row-parallel product is summed.  An attention layer runs on
its rank's heads only when q, k and v are all column-sharded and the head
counts divide ``model``; otherwise it gathers q, k and v and runs every
head (the dense path GSPMD would partition).
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist

from .sharding import MODEL

# torch 2.13 renames all_gather_into_tensor (the old name warns); older torch
# has only the old name
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
# collectives issued, by kind (a captured graph's replays add what its capture issued)
CALLS = {"all_reduce": 0, "all_gather": 0, "ring_pass": 0}


class Axis:
    """One mesh axis as seen from this rank: its group, size and coordinate."""

    def __init__(self, mesh, name: str):
        self.name = name
        self.group = mesh.get_group(name)
        self.size = mesh.size(mesh.mesh_dim_names.index(name))
        self.rank = mesh.get_local_rank(name)

    def __repr__(self):
        return f"Axis({self.name!r}, {self.rank}/{self.size})"


def axis(mesh, name: str) -> Optional[Axis]:
    """``name`` of ``mesh`` as an ``Axis``, or None where the mesh lacks it."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return None
    return Axis(mesh, name)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (every rank gets it)."""
    x = x.contiguous()
    dist.all_reduce(x, group=group)
    CALLS["all_reduce"] += 1
    return x


def _gather0(x: torch.Tensor, group, size: int) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty((size * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _all_gather(out, x, group=group)
    CALLS["all_gather"] += 1
    return out


def gather_from_model(x: torch.Tensor, group, size: int, dim: int = -1) -> torch.Tensor:
    """Each rank's slice of ``x`` on axis ``dim``, concatenated in rank order,
    contiguous (a strided result would change how later GEMMs and norms
    round)."""
    out = _gather0(x.movedim(dim, 0), group, size)  # (size * w, ...)
    return out.movedim(0, dim).contiguous()


def gather_rows_from_data(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """Each rank's rows (axis 0) of ``x``, stacked in rank order."""
    return _gather0(x, group, size)


def ring_pass(tensors: Iterable[torch.Tensor], group, size: int, rank: int
              ) -> List[torch.Tensor]:
    """Send each tensor to the next rank of ``group`` and receive the
    previous rank's, all in one ``batch_isend_irecv``."""
    tensors = [t.contiguous() for t in tensors]
    ranks = dist.get_process_group_ranks(group)
    nxt, prev = ranks[(rank + 1) % size], ranks[(rank - 1) % size]
    out = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, o in zip(tensors, out):
        ops.append(dist.P2POp(dist.isend, t, nxt, group))
        ops.append(dist.P2POp(dist.irecv, o, prev, group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    CALLS["ring_pass"] += 1
    return out


# ---------------------------------------------------------------------------
# tensor-parallel layers
# ---------------------------------------------------------------------------

def _weight_spec(mod, specs: dict, prefix: str) -> Tuple[bool, bool]:
    """(input sharded, output sharded) of a dense, int8 or int4 linear."""
    from ..ops.linear import Int4Linear

    if isinstance(mod, Int4Linear):  # carrier (G, gs/2, out)
        s = specs[prefix + "q"]
        return s[0] == MODEL, s[2] == MODEL
    s = specs[prefix + ("q" if hasattr(mod, "q") else "weight")]  # (out, in)
    return s[1] == MODEL, s[0] == MODEL


def attach(model, mesh, specs: dict) -> None:
    """Record on ``model`` (a ``VisualCLAModel`` sliced by ``specs``) how each
    of its layers runs over ``mesh``'s ``model`` axis."""
    from ..ops.linear import Int4Linear, Int8Linear, Linear, LoraLinear

    tp = axis(mesh, MODEL)
    model.mesh = mesh
    for name, mod in model.named_modules():
        if isinstance(mod, LoraLinear) and tp is not None:
            raise NotImplementedError(
                "LoRA layers over a mesh are not ported: fold the adapter first "
                "(ROADMAP, open item 17: training over a mesh)")
        if isinstance(mod, (Linear, Int8Linear, Int4Linear)):
            mod.tp = tp
            mod.tp_in, mod.tp_out = (_weight_spec(mod, specs, name + ".") if tp is not None
                                     else (False, False))
    text = getattr(model, "text", None)  # a VisionTowers has none
    if text is not None:
        text.tp = tp
        text.embed_local = tp is not None and MODEL in specs.get(
            "text.embed_tokens", specs.get("text.embed_tokens.q", ()))
        for layer in text.layers:
            layer.heads = _heads(tp, layer, (layer.q_proj, layer.k_proj, layer.v_proj),
                                 text.cfg.num_attention_heads, text.cfg.num_key_value_heads)
        if text.layers:
            text.kv_heads = text.layers[0].heads[1]
    vision = model.vision
    vision.tp = tp
    vision.embed_local = vision.patch_embedding.tp_out and (
        specs["vision.position_embedding"][1] == MODEL)
    towers = [vision.layers]
    if model.resampler is not None:
        towers.append(model.resampler.layers)
    for layers in towers:
        for layer in layers:
            n = layer.num_heads
            layer.heads = _heads(tp, layer, (layer.q_proj, layer.k_proj, layer.v_proj), n, n)


def _heads(tp: Optional[Axis], layer, qkv, n: int, nkv: int) -> Tuple[int, int, int, bool]:
    """(q heads, kv heads, first q head, local) of an attention layer on this
    rank: its share when q, k, v are column-sharded and both head counts
    divide ``model`` (``local``), else every head."""
    local = (tp is not None and all(m.tp_out for m in qkv)
             and n % tp.size == 0 and nkv % tp.size == 0)
    if not local:
        return n, nkv, 0, False
    return n // tp.size, nkv // tp.size, tp.rank * (n // tp.size), True


def local_columns(x: torch.Tensor, tp: Axis) -> torch.Tensor:
    """This rank's contiguous slice of ``x``'s last axis."""
    w = x.shape[-1] // tp.size
    return x[..., tp.rank * w:(tp.rank + 1) * w]


def linear(mod, x: torch.Tensor, x_local: bool = False, f32: bool = False
           ) -> Tuple[torch.Tensor, bool]:
    """``mod(x)`` (``mod.forward_f32`` with ``f32``) over the mesh, where ``x``
    is this rank's last-axis slice when ``x_local``.  -> (y, y is this
    rank's last-axis slice).  A row-parallel bias is added once: rank 0 adds
    it to its partial product before the sum."""
    tp = getattr(mod, "tp", None)
    if tp is None:
        return (mod.forward_f32(x) if f32 else mod(x)), False
    if mod.tp_in:  # row-parallel: partial outputs, summed
        if not x_local:
            x = local_columns(x, tp)
        y = mod.partial(x, f32=f32, bias=tp.rank == 0)
        return mod.finish(reduce_from_model(y, tp.group)), False
    if x_local:
        x = gather_from_model(x, tp.group, tp.size)
    return (mod.forward_f32(x) if f32 else mod(x)), mod.tp_out


def whole(y: torch.Tensor, y_local: bool, tp: Optional[Axis]) -> torch.Tensor:
    """``y`` whole: gathered over ``model`` where it is a rank's slice."""
    return gather_from_model(y, tp.group, tp.size) if y_local else y


def qkv(layer, x: torch.Tensor, kv_x: Optional[torch.Tensor] = None):
    """An attention layer's q (from ``x``), k and v (from ``kv_x``, default
    ``x``) over the mesh, on the layer's heads (``layer.heads``): this
    rank's share where they are local, else every head.  -> (q, k, v)."""
    kv_x = x if kv_x is None else kv_x
    outs = [linear(layer.q_proj, x), linear(layer.k_proj, kv_x), linear(layer.v_proj, kv_x)]
    heads = getattr(layer, "heads", None)
    if heads is not None and heads[3]:
        return tuple(y for y, _ in outs)
    tp = getattr(layer.q_proj, "tp", None)
    return tuple(whole(y, yl, tp) for y, yl in outs)


def out_proj(mod, attn: torch.Tensor, heads) -> torch.Tensor:
    """The attention output projection over the mesh, whole; ``attn`` holds
    this rank's heads where ``heads`` says they are local."""
    y, yl = linear(mod, attn, x_local=heads is not None and heads[3])
    return whole(y, yl, getattr(mod, "tp", None))


def mlp(up_mods, down, x: torch.Tensor, fn) -> torch.Tensor:
    """``down(fn(*[m(x) for m in up_mods]))`` over the mesh, whole: the
    column-parallel products stay a rank's slice into the row-parallel one."""
    ys = [linear(m, x) for m in up_mods]
    local = all(yl for _, yl in ys)
    tp = getattr(down, "tp", None)
    hs = [y if local else whole(y, yl, tp) for y, yl in ys]
    y, yl = linear(down, fn(*hs), x_local=local)
    return whole(y, yl, tp)
