"""FSDP at runtime: every layer stack's layer axis sharded over ``data``
(the runtime of ``sharding.param_specs(fsdp=True)``, ZeRO-style).

The layers of a tower are an ``nn.ModuleList``, so data rank r owns layers
``[r L/n, (r+1) L/n)`` of each stack whose length ``n`` divides (the text
tower's must: ``ValueError`` otherwise, as the JAX CLI requires) and holds an
empty tensor in place of every other layer's parameters, so a rank stores
1/n of the stack and, for the trainable ones, 1/n of their optimizer state.
A layer runs through ``call``: its weights are broadcast from the owner
(model shards as they are) into new tensors, the layer runs on them
(``torch.func.functional_call``), and they are freed with the graph; a
recompute under remat gathers them again.  Under autograd the broadcast's
backward sums the data ranks' gradients onto the owner (``dist.reduce``),
so an owned parameter's gradient is summed over ``data`` already and the
other ranks keep none.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from . import tp
from .sharding import DATA


class _FromOwner(torch.autograd.Function):
    """The owner's tensors on every rank of the axis; backward: the
    gradients summed onto the owner."""

    @staticmethod
    def forward(ctx, ax, owner, shapes, *tensors):
        ctx.ax, ctx.owner = ax, owner
        return tuple(_broadcast(t, shape, ax, owner) for t, shape in zip(tensors, shapes))

    @staticmethod
    def backward(ctx, *grads):
        ax, owner = ctx.ax, ctx.owner
        out = []
        for g in grads:
            g = tp.reduce_to(g.contiguous().clone(), ax.group, owner)
            out.append(g if ax.rank == owner else None)
        return (None, None, None, *out)


def _broadcast(t: torch.Tensor, shape, ax, owner: int) -> torch.Tensor:
    buf = (t.detach().clone() if ax.rank == owner
           else torch.empty(shape, dtype=t.dtype, device=t.device))
    return tp.broadcast(buf, ax.group, owner)


def shard_layers(model: nn.Module, mesh) -> nn.Module:
    """Keep on this rank the layers it owns of each of ``model``'s layer
    stacks (text, vision, resampler) over ``mesh``'s ``data`` axis, in place
    (after ``shard_params``' model-axis slicing).  -> ``model``."""
    data = tp.axis(mesh, DATA)
    if data is None:
        raise ValueError("FSDP needs a mesh with a 'data' axis")
    text = model.text
    if len(text.layers) % data.size:
        raise ValueError(f"FSDP: num_hidden_layers {len(text.layers)} not divisible by "
                         f"data={data.size}")
    towers = [text, model.vision] + ([model.resampler] if model.resampler is not None else [])
    for tower in towers:
        layers = tower.layers
        if len(layers) % data.size:
            continue  # a stack that does not divide stays whole, as _valid_spec says
        per = len(layers) // data.size
        for l, layer in enumerate(layers):
            own_layer(layer, data, l // per)
    return model


@torch.no_grad()
def own_layer(layer: nn.Module, ax: tp.Axis, owner: int, run_gathered: bool = True) -> None:
    """Mark ``layer``'s parameters as held by rank ``owner`` of ``ax``; the
    other ranks keep an empty tensor in place of each.  ``run_gathered``:
    every rank of ``ax`` runs the layer (``call`` gathers it); else only the
    owner does (a pipeline stage's layer)."""
    for p in layer.parameters():
        p.owner = (ax, owner, tuple(p.shape))
        if ax.rank != owner:
            p.data = p.data.new_empty(0)
    if run_gathered:
        layer.fsdp = (ax, owner)


def gathered(layer: nn.Module) -> Dict[str, torch.Tensor]:
    """{name: tensor} of ``layer``'s parameters, broadcast from their owner:
    the trainable ones through one autograd node, the frozen ones plain."""
    ax, owner = layer.fsdp
    named = list(layer.named_parameters())
    out = {}
    with torch.no_grad():
        for n, p in named:
            if not p.requires_grad:
                out[n] = _broadcast(p, p.owner[2], ax, owner)
    train = [(n, p) for n, p in named if p.requires_grad]
    if train:
        if torch.is_grad_enabled():
            ts = _FromOwner.apply(ax, owner, [p.owner[2] for _, p in train],
                                  *[p for _, p in train])
        else:
            ts = [_broadcast(p, p.owner[2], ax, owner) for _, p in train]
        out.update({n: t for (n, _), t in zip(train, ts)})
    return {n: out[n] for n, _ in named}


def call(layer: nn.Module, *args, **kwargs):
    """``layer(*args, **kwargs)``, on its gathered weights when FSDP holds
    them on one data rank."""
    if getattr(layer, "fsdp", None) is None:
        return layer(*args, **kwargs)
    return torch.func.functional_call(layer, gathered(layer), args, kwargs)
