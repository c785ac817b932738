"""Pipeline parallelism of the LLaMA decoder stack (port of
visualcla_tpu/parallel/pipeline.py).

A ``pipe`` axis cuts the L layers into P stages of L/P: ``shard_text_params``
keeps only its stage's layers on a rank (the others hold an empty tensor in
place of each parameter), and under a ``(pipe, model)`` mesh slices them for
Megatron TP within the stage (``parallel.tp``).  ``pipeline_forward`` runs
GPipe over M microbatches in T = M + P - 1 ticks: at tick t stage s runs
microbatch t - s through its layers and hands the activation to stage s + 1
(``tp.pipe_hop``, a paired ``batch_isend_irecv``, so gloo and NCCL cannot
deadlock; an idle tick computes nothing, and every send has its receive in
the same hop).  The last stage's output reaches every stage by a broadcast
over ``pipe``.  At P = 1 there is no stage boundary and so no hop; the
broadcast over the one-rank group still runs.  With a ``data`` axis each
data rank runs its rows of the batch (B divisible by M x data) and the
hidden states are gathered back whole.

The cached form (inference) runs each stage's layers over its own
(L/P, B, Nkv, S, hd) cache (``pipeline_kv_cache``) through
``cached_attention(layer_index=local l)``: kernel B2 for a prefill, B1 for a
decode step, their int8 forms over an int8 cache.  The cache-free form
(training, ``kv_cache=None``) is differentiable: the schedule is one
autograd node whose backward runs the reverse schedule (each microbatch's
gradient hops to stage s - 1), stage 0 holding the embeddings' gradient,
which is broadcast over ``pipe`` so that everything outside the stack gets
the same gradient on every stage, once: every stage computes the same loss
from the broadcast output, and the backward takes that one loss's gradient
(it does not sum the P copies).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.utils.checkpoint
from torch import nn

from ..ops.cuda.flash_attention import slot_vector
from ..ops.rope import rope_table
from . import fsdp, tp
from .sharding import mesh_shape, slice_tensors, state_specs

PIPE, DATA, MODEL = "pipe", "data", "model"


def _mesh(shape: tuple, names: tuple, device_type: Optional[str]):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if shape[0] * shape[1] != world:
        raise ValueError(f"mesh {dict(zip(names, shape))} does not cover {world} ranks")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_pipe_mesh(n_pipe: int, n_data: int = 1, device_type: Optional[str] = None):
    """A ('pipe', 'data') ``DeviceMesh`` over the world, ``pipe`` the outer
    axis (stage boundaries are point-to-point hops: the traffic that best
    tolerates the slower links between nodes)."""
    return _mesh((n_pipe, n_data), (PIPE, DATA), device_type)


def make_pipe_tp_mesh(n_pipe: int, n_model: int, device_type: Optional[str] = None):
    """A ('pipe', 'model') ``DeviceMesh``: stages on the outer axis, Megatron
    TP within each stage."""
    return _mesh((n_pipe, n_model), (PIPE, MODEL), device_type)


def stage_param_specs(n_pipe: int, cfg, tp: bool = False) -> dict:
    """The text tower's specs under PP (the JAX package's): the stacked layer
    tensors' leading axis on 'pipe', the rest whole; ``tp=True`` adds the
    Megatron specs on 'model' within each stage."""
    if cfg.num_hidden_layers % n_pipe:
        raise ValueError(f"num_hidden_layers {cfg.num_hidden_layers} not divisible by "
                         f"pipe={n_pipe}")
    col = (PIPE, None, MODEL) if tp else (PIPE, None, None)
    row = (PIPE, MODEL, None) if tp else (PIPE, None, None)
    layer_spec = {"input_norm": (PIPE,), "post_norm": (PIPE,)}
    for name in ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj"):
        layer_spec[name] = col
    for name in ("o_proj", "down_proj"):
        layer_spec[name] = row
    return {"embed_tokens": (None, MODEL) if tp else (), "layers": layer_spec,
            "final_norm": (), "lm_head": (None, MODEL) if tp else ()}


def stage_layers(n_layers: int, pipe: tp.Axis) -> range:
    """The layer indices stage ``pipe.rank`` runs."""
    per = n_layers // pipe.size
    return range(pipe.rank * per, (pipe.rank + 1) * per)


class _TextHolder(nn.Module):
    """A bare text tower under the composite model's names (``text.``)."""

    def __init__(self, text):
        super().__init__()
        self.text = text


@torch.no_grad()
def shard_text_params(model: nn.Module, mesh, cfg=None) -> nn.Module:
    """Place the text tower of ``model`` (a ``VisualCLAModel``, or a bare
    ``Llama``) on ``mesh``, in place: this rank keeps its stage's L/P layers
    and an empty tensor in place of every other layer's parameters; under a
    ('pipe', 'model') mesh the text tower's tensors are sliced by the
    Megatron rules and ``tp.attach`` sets up the stage's collectives (the
    vision side stays whole, as in the JAX package).  -> ``model``."""
    text = getattr(model, "text", model)
    sizes = mesh_shape(mesh)
    stage_param_specs(sizes[PIPE], text.cfg if cfg is None else cfg, tp=MODEL in sizes)
    pipe = tp.axis(mesh, PIPE)
    if MODEL in sizes:
        holder = model if hasattr(model, "text") else _TextHolder(text)
        specs = {name: (spec if name.startswith("text.") else ())
                 for name, spec in state_specs(holder, mesh).items()}
        slice_tensors(holder, specs, mesh)
        tp.attach(holder, mesh, specs)
    per = len(text.layers) // pipe.size
    for l, layer in enumerate(text.layers):
        fsdp.own_layer(layer, pipe, l // per, run_gathered=False)
    return model


def pipeline_kv_cache(cfg, batch: int, max_len: int, dtype, mesh, kv_quant: str = "none", *,
                      kv_heads: Optional[int] = None, device=None) -> dict:
    """This rank's KV cache under PP: its stage's L/P layers, its data rows
    (batch / data), ``kv_heads`` heads (``Llama.kv_heads``: a stage's share
    under TP; default the config's).  On the card unless ``device`` says."""
    from ..api import _default_device
    from ..models.llama import init_kv_cache

    sizes = mesh_shape(mesh)
    n_data = sizes.get(DATA, 1)
    if batch % n_data:
        raise ValueError(f"batch {batch} must be divisible by data={n_data}")
    local = dataclasses.replace(cfg, num_hidden_layers=cfg.num_hidden_layers // sizes[PIPE])
    device = _default_device() if device is None else torch.device(device)
    return init_kv_cache(local, batch // n_data, max_len, dtype, device=device,
                         kv_quant=kv_quant, kv_heads=kv_heads)


def pipeline_forward(text: nn.Module, cfg, inputs_embeds: torch.Tensor,
                     rope_positions: torch.Tensor, kv_cache: Optional[dict],
                     kv_valid: torch.Tensor, write_slot, mesh, n_micro: int = 1,
                     remat: bool = False) -> Tuple[torch.Tensor, Optional[dict]]:
    """The decoder stack under PP (the embedding and everything before it
    outside, on every rank): the same numbers as ``Llama.forward``, another
    schedule.  ``text`` is the ``Llama`` that ``shard_text_params`` placed;
    the inputs are the whole batch, the same on every rank; ``kv_cache``
    this rank's (``pipeline_kv_cache``), written in place, or None for the
    cache-free training form (``kv_valid`` then (B, Sq)).  -> (final-normed
    hidden (B, Sq, H) on every rank, kv_cache)."""
    data = tp.axis(mesh, DATA)
    B = inputs_embeds.shape[0]
    n_data = data.size if data is not None else 1
    check_batch(B, n_micro, n_data)
    if n_data > 1:
        w = B // n_data
        rows = slice(data.rank * w, (data.rank + 1) * w)
        inputs_embeds, rope_positions, kv_valid = (
            inputs_embeds[rows], rope_positions[rows], kv_valid[rows])
        if isinstance(write_slot, torch.Tensor) and write_slot.numel() == B:
            write_slot = write_slot.reshape(-1)[rows]
    h = stack_forward(text, cfg, inputs_embeds, rope_positions, kv_cache, kv_valid, write_slot,
                      mesh, n_micro, remat)
    if n_data > 1:
        h = tp.gather_rows_from_data(h, data.group, n_data)
    return h, kv_cache


def check_batch(B: int, n_micro: int, n_data: int) -> None:
    if B % (n_micro * n_data):
        raise ValueError(f"batch {B} must be divisible by n_micro*data={n_micro * n_data}")


def stack_forward(text: nn.Module, cfg, embeds: torch.Tensor, positions: torch.Tensor,
                  cache: Optional[dict], kv_valid: torch.Tensor, write_slot, mesh,
                  n_micro: int, remat: bool = False) -> torch.Tensor:
    """``pipeline_forward`` on this data rank's rows: -> their final-normed
    hidden states, on every stage."""
    pipe = tp.axis(mesh, PIPE)
    M = n_micro
    check_batch(embeds.shape[0], M, 1)
    mb = embeds.shape[0] // M
    cos, sin = rope_table(positions, cfg.head_dim, cfg.rope_theta)
    layers = [text.layers[l] for l in stage_layers(len(text.layers), pipe)]
    per_row = isinstance(write_slot, torch.Tensor) and write_slot.numel() > 1

    def micro(m: int, h: torch.Tensor) -> torch.Tensor:
        r = slice(m * mb, (m + 1) * mb)
        ws = write_slot.reshape(-1)[r] if per_row else write_slot
        if cache is None:  # cache-free: each layer attends over the microbatch's own K/V
            cm, slots, ws = None, None, 0
        else:  # the microbatch's rows of the stage's cache: views, written in place
            cm = {k: v[:, r] for k, v in cache.items()}
            slots = slot_vector(ws, mb, h.device)
        for j, layer in enumerate(layers):
            args = (h, cos[r], sin[r], cm, kv_valid[r], ws, slots, j)
            h = (torch.utils.checkpoint.checkpoint(layer, *args, use_reentrant=False)
                 if remat else layer(*args))
        return h

    run = _Schedule(micro, pipe, M, embeds)
    if torch.is_grad_enabled() and (embeds.requires_grad or any(
            p.requires_grad for p in text.layers.parameters())):
        token = torch.empty(0, device=embeds.device, requires_grad=True)
        hidden = _Pipeline.apply(embeds, token, run)
    else:
        hidden = run.forward(embeds)
    outs = [text.final_norm(hidden[m * mb:(m + 1) * mb]) for m in range(M)]
    return outs[0] if M == 1 else torch.cat(outs)


class _Schedule:
    """GPipe's ticks for one call: ``micro(m, h)`` runs microbatch m through
    the stage's layers."""

    def __init__(self, micro, pipe: tp.Axis, M: int, embeds: torch.Tensor):
        self.micro, self.pipe, self.M = micro, pipe, M
        self.mb = embeds.shape[0] // M
        self.shape = (self.mb,) + tuple(embeds.shape[1:])
        self.dtype, self.device = embeds.dtype, embeds.device
        self.ins, self.outs = {}, {}

    def forward(self, embeds: torch.Tensor, keep: bool = False) -> torch.Tensor:
        """-> the last stage's (B_rows, Sq, H) output on every stage.  ``keep``:
        each microbatch's input is a leaf and its output keeps its graph
        (``ins`` / ``outs``), for ``backward``."""
        s, P, M, mb = self.pipe.rank, self.pipe.size, self.M, self.mb
        done, buf = [], None
        for t in range(M + P - 1):
            m, h = t - s, None
            if 0 <= m < M:
                x = embeds[m * mb:(m + 1) * mb] if s == 0 else buf
                if keep:
                    x = x.detach().requires_grad_()
                    self.ins[m] = x
                h = self.micro(m, x)
                if keep:
                    self.outs[m] = h
                    h = h.detach()
                if s == P - 1:
                    done.append(h)
            nxt = t + 1 - s  # the microbatch this stage runs next tick
            buf = tp.pipe_hop(h if h is not None and s < P - 1 else None,
                              (self.shape, self.dtype) if s > 0 and 0 <= nxt < M else None,
                              self.pipe.group, s, P, self.device)
        out = (torch.cat(done) if s == P - 1
               else torch.empty((M * mb,) + self.shape[1:], dtype=self.dtype, device=self.device))
        return tp.broadcast(out, self.pipe.group, P - 1)

    def backward(self, g: torch.Tensor) -> torch.Tensor:
        """The reverse schedule from ``g``, the gradient of the output (the
        same on every stage: the last stage's is taken, once).  -> the
        gradient of the embeddings, on every stage."""
        s, P, M, mb = self.pipe.rank, self.pipe.size, self.M, self.mb
        g_in, buf = [None] * M, None
        for t in range(M + P - 1):
            m, gx = M - 1 - (t - (P - 1 - s)), None
            if 0 <= m < M:
                gy = g[m * mb:(m + 1) * mb] if s == P - 1 else buf
                torch.autograd.backward(self.outs.pop(m), gy)
                gx = self.ins.pop(m).grad
                if s == 0:
                    g_in[m] = gx
            nxt = M - 1 - (t + 1 - (P - 1 - s))
            buf = tp.pipe_hop(gx if gx is not None and s > 0 else None,
                              (self.shape, self.dtype) if s < P - 1 and 0 <= nxt < M else None,
                              self.pipe.group, s, P, self.device, reverse=True)
        out = (torch.cat(g_in) if s == 0
               else torch.empty((M * mb,) + self.shape[1:], dtype=self.dtype, device=self.device))
        return tp.broadcast(out, self.pipe.group, 0)


class _Pipeline(torch.autograd.Function):
    """The schedule as one autograd node: the stage's layer parameters get
    their gradients inside ``backward``; ``token`` (empty, requires grad)
    makes every stage run the backward."""

    @staticmethod
    def forward(ctx, embeds, token, run):
        ctx.run = run
        with torch.enable_grad():
            return run.forward(embeds, keep=True)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            return ctx.run.backward(g.contiguous()), None, None
