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
  send to the next seq rank, receive from the previous one);
- ``pipe_hop``: one hop between pipeline stages (``batch_isend_irecv``, each
  send paired with the neighbour's receive);
- ``broadcast`` / ``reduce_to``: one rank's tensor to every rank of a group,
  and a sum onto one rank (FSDP's owners, the pipeline's last stage).

``attach`` sets up a model whose tensors ``sharding.shard_params`` sliced:
each linear learns from its weight's actual spec whether its input
(row-parallel: the partial outputs are summed, the bias added once after
the sum) or its output (column-parallel: the rank's columns) is sharded;
``linear`` then applies the one rule: a sharded input that the weight needs
whole is gathered first, a whole input that the weight holds rows of is
sliced, and a row-parallel product is summed.  An attention layer runs on
its rank's heads only when q, k and v are all column-sharded and the head
counts divide ``model``; otherwise it gathers q, k and v and runs every
head (the dense path GSPMD would partition).  A ``LoraLinear`` runs its
base as the base's spec says; its A and B stay whole on every rank: a
column-parallel base takes its rank's columns of ``x A B``, a row-parallel
one adds the LoRA term once to the summed output (the bias's rule).

Under autograd each collective is a ``torch.autograd.Function`` whose
backward is its transpose, given that every rank computes the same thing
downstream of it: the sum over ``model`` <-> identity; the gather of
column shards <-> the rank's slice of the gradient; the slice of a whole
input <-> the gather of the gradient slices; the gather of data rows <->
the rank's rows; and ``copy_to_model`` (the whole input of a
column-parallel product: identity) <-> the sum of the partial input
gradients over ``model``.  So a replicated tensor's gradient is whole and
equal on every rank, and a sharded leaf's is the rank's shard of the
whole gradient.  Without gradients every collective issues the same
operations as before (the sum in place, no copy).
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist

from .sharding import MODEL

# torch 2.13 renames all_gather_into_tensor (the old name warns); older torch
# has only the old name
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
# collectives issued, by kind, backward passes included (a captured graph's
# replays add what its capture issued)
CALLS = {"all_reduce": 0, "all_gather": 0, "ring_pass": 0, "pipe_hop": 0, "broadcast": 0,
         "reduce": 0}


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

def _grad_path(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(x, group=group)
    CALLS["all_reduce"] += 1
    return x


def _narrow(x: torch.Tensor, dim: int, rank: int, size: int) -> torch.Tensor:
    w = x.shape[dim] // size
    return x.narrow(dim, rank * w, w)


class _Sum(torch.autograd.Function):
    """The sum over a group (a copy: the input may be saved for the
    backward); backward: identity."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Copy(torch.autograd.Function):
    """Identity; backward: the sum of the gradients over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.contiguous().clone(), ctx.group), None


class _Gather(torch.autograd.Function):
    """The ranks' slices on ``dim`` concatenated; backward: the rank's slice."""

    @staticmethod
    def forward(ctx, x, group, size, dim):
        ctx.rank, ctx.size, ctx.dim = dist.get_rank(group), size, dim
        return _gather_dim(x, group, size, dim)

    @staticmethod
    def backward(ctx, g):
        return _narrow(g, ctx.dim, ctx.rank, ctx.size).contiguous(), None, None, None


class _Slice(torch.autograd.Function):
    """The rank's slice of a whole tensor on ``dim``; backward: the ranks'
    gradient slices gathered (the whole input's gradient)."""

    @staticmethod
    def forward(ctx, x, group, rank, size, dim):
        ctx.group, ctx.size, ctx.dim = group, size, dim
        return _narrow(x, dim, rank, size).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g, ctx.group, ctx.size, ctx.dim), None, None, None, None


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (every rank gets it); in place unless
    autograd records it."""
    if _grad_path(x):
        return _Sum.apply(x, group)
    return _all_reduce_(x.contiguous(), group)


def copy_to_model(x: torch.Tensor, tp: "Axis") -> torch.Tensor:
    """``x`` (whole, equal on every rank) as the input of a column-parallel
    product: no operation forward; under autograd the partial input
    gradients are summed over ``model``."""
    return _Copy.apply(x, tp.group) if _grad_path(x) else x


def _gather0(x: torch.Tensor, group, size: int) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty((size * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _all_gather(out, x, group=group)
    CALLS["all_gather"] += 1
    return out


def _gather_dim(x: torch.Tensor, group, size: int, dim: int) -> torch.Tensor:
    out = _gather0(x.movedim(dim, 0), group, size)  # (size * w, ...)
    return out.movedim(0, dim).contiguous()


def gather_from_model(x: torch.Tensor, group, size: int, dim: int = -1) -> torch.Tensor:
    """Each rank's slice of ``x`` on axis ``dim``, concatenated in rank order,
    contiguous (a strided result would change how later GEMMs and norms
    round)."""
    if _grad_path(x):
        return _Gather.apply(x, group, size, dim % x.dim())
    return _gather_dim(x, group, size, dim)


def gather_rows_from_data(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """Each rank's rows (axis 0) of ``x``, stacked in rank order."""
    if _grad_path(x):
        return _Gather.apply(x, group, size, 0)
    return _gather0(x, group, size)


def broadcast(x: torch.Tensor, group, src: int) -> torch.Tensor:
    """``x`` of the group's rank ``src`` on every rank of ``group``, in place
    (the other ranks pass a buffer of its shape and dtype)."""
    dist.broadcast(x, src=dist.get_global_rank(group, src), group=group)
    CALLS["broadcast"] += 1
    return x


def reduce_to(x: torch.Tensor, group, dst: int) -> torch.Tensor:
    """The sum of ``x`` over ``group`` on the group's rank ``dst``, in place
    (the other ranks' ``x`` is left undefined)."""
    dist.reduce(x, dst=dist.get_global_rank(group, dst), group=group)
    CALLS["reduce"] += 1
    return x


def pipe_hop(send: Optional[torch.Tensor], recv: Optional[Tuple[tuple, torch.dtype]],
             group, rank: int, size: int, device, reverse: bool = False
             ) -> Optional[torch.Tensor]:
    """One hop of the pipeline between neighbouring stages: send ``send``
    (if any) to the next rank of ``group`` and receive a tensor of
    ``recv``'s (shape, dtype) (if any) from the previous one, both in one
    ``batch_isend_irecv`` (``reverse``: to the previous rank and from the
    next, the backward pass's direction).  The caller pairs every send with
    the neighbour's receive in the same hop.  -> the received tensor."""
    ranks = dist.get_process_group_ranks(group)
    step = -1 if reverse else 1
    ops, out = [], None
    if send is not None:
        ops.append(dist.P2POp(dist.isend, send.contiguous(), ranks[rank + step], group))
    if recv is not None:
        out = torch.empty(recv[0], dtype=recv[1], device=device)
        ops.append(dist.P2POp(dist.irecv, out, ranks[rank - step], group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        CALLS["pipe_hop"] += 1
    return out


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
        s = tuple(specs[prefix + "q"]) + (None,) * 3
        return s[0] == MODEL, s[2] == MODEL
    s = tuple(specs[prefix + ("q" if hasattr(mod, "q") else "weight")]) + (None,) * 2
    return s[1] == MODEL, s[0] == MODEL  # (out, in)


def attach(model, mesh, specs: dict) -> None:
    """Record on ``model`` (a ``VisualCLAModel`` sliced by ``specs``) how each
    of its layers runs over ``mesh``'s ``model`` axis."""
    from ..ops.linear import Int4Linear, Int8Linear, Linear, LoraLinear

    tp = axis(mesh, MODEL)
    model.mesh = mesh
    for name, mod in model.named_modules():
        base, prefix = ((mod.base, name + ".base.") if isinstance(mod, LoraLinear)
                        else (mod, name + "."))
        if isinstance(base, (Linear, Int8Linear, Int4Linear)):
            mod.tp = tp
            mod.tp_in, mod.tp_out = (_weight_spec(base, specs, prefix) if tp is not None
                                     else (False, False))
    for name, p in model.named_parameters():  # what the optimizer and the saves read
        spec = specs.get(name, ())
        if tp is not None and MODEL in spec:
            p.shard = (tp, spec.index(MODEL))
        elif hasattr(p, "shard"):
            del p.shard
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
        specs.get("vision.position_embedding", ())[1:2] == (MODEL,))
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
    """This rank's contiguous slice of ``x``'s last axis (a view; under
    autograd a copy whose gradient is gathered whole)."""
    if _grad_path(x):
        return _Slice.apply(x, tp.group, tp.rank, tp.size, x.dim() - 1)
    w = x.shape[-1] // tp.size
    return x[..., tp.rank * w:(tp.rank + 1) * w]


def linear(mod, x: torch.Tensor, x_local: bool = False, f32: bool = False
           ) -> Tuple[torch.Tensor, bool]:
    """``mod(x)`` (``mod.forward_f32`` with ``f32``) over the mesh, where ``x``
    is this rank's last-axis slice when ``x_local``.  -> (y, y is this
    rank's last-axis slice).  A row-parallel bias is added once: rank 0 adds
    it to its partial product before the sum (under autograd every rank
    adds it to the sum)."""
    tp = getattr(mod, "tp", None)
    if tp is None:
        return (mod.forward_f32(x) if f32 else mod(x)), False
    if hasattr(mod, "lora_A"):
        return _lora_linear(mod, x, x_local, tp)
    if mod.tp_in:  # row-parallel: partial outputs, summed
        if not x_local:
            x = local_columns(x, tp)
        bias = getattr(mod, "bias", None)
        if bias is not None and torch.is_grad_enabled() and (
                x.requires_grad or any(p.requires_grad for p in mod.parameters())):
            # under autograd every rank adds the bias after the sum, so its
            # gradient is whole on every rank
            y = mod.finish(reduce_from_model(mod.partial(x, f32=f32, bias=False), tp.group))
            return y + (bias.float() if f32 else bias), False
        y = mod.partial(x, f32=f32, bias=tp.rank == 0)
        return mod.finish(reduce_from_model(y, tp.group)), False
    if x_local:
        x = gather_from_model(x, tp.group, tp.size)
    if mod.tp_out:
        x = copy_to_model(x, tp)
    return (mod.forward_f32(x) if f32 else mod(x)), mod.tp_out


def _lora_linear(mod, x: torch.Tensor, x_local: bool, tp: Axis) -> Tuple[torch.Tensor, bool]:
    """A ``LoraLinear`` over the mesh: the base by its spec, the LoRA term
    ``(x A) B * scale`` on the whole input with the whole A and B, then the
    bias (the rank's columns of it where the base is column-parallel)."""
    base = mod.base
    if not (mod.tp_in or mod.tp_out):  # a base that stays whole
        return mod(gather_from_model(x, tp.group, tp.size) if x_local else x), False
    x_whole = gather_from_model(x, tp.group, tp.size) if x_local else x
    term = mod.lora_term(x_whole)  # first, as LoraLinear.forward
    if mod.tp_in:  # row-parallel: the term added once, to the sum
        x_part = x if x_local else local_columns(x, tp)
        y = base.finish(reduce_from_model(base.partial(x_part, bias=False), tp.group)) + term
        local = False
    else:  # column-parallel: the rank's columns of the term
        y = base(copy_to_model(x_whole, tp)) + local_columns(term, tp)
        local = True
    return (y if mod.bias is None else y + mod.bias), local


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
