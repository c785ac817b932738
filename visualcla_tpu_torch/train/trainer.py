"""Multimodal training step on autograd (port of visualcla_tpu/train/trainer.py).

The modules hold the parameters, so a step is built over the model: a
``TrainState``'s ``params`` is a dict of the model's own parameters by module
name, and a step updates them, and the optimizer state, in place.  The loss
is the HF causal-LM loss (labels aligned to the inputs, shifted inside,
``-100`` ignored).  The trainable-subset predicates take the JAX package's
leaf paths (``stage1_trainable(("text", "layers", "q_proj"))``): each module
name maps to its JAX path once (``param_paths``), so one predicate picks the
same leaves in both packages.

``make_train_step`` differentiates every parameter and zeroes the masked
gradients, as the JAX step does (its optimizer then steps every leaf, so a
frozen one still decays with ``weight_decay > 0``); ``make_train_step_subset``
keeps gradients and optimizer state for the trainable partition only, the
QLoRA form: the frozen partition, an int8 or int4 base included, never requires
grad.  ``make_optimizer`` is optax's ``chain(clip_by_global_norm,
adamw)`` over such dicts (``Optimizer``).  The forward is cache-free and
runs dense attention only (the attention kernels have no backward, and the
JAX package's training runs no Pallas attention either).  Over a frozen
int4 text tower every product runs kernel B3 forward, and its input
gradient is ``Int4MatmulFn``'s backward: the transpose of the XLA form that
``jax.grad`` differentiates in the JAX package.

Over a mesh (explicit SPMD: every rank makes the same calls with the same
global batch) a step runs on the model's ``(data, model)`` mesh
(``parallel.sharding.shard_params``, with ``fsdp=True`` or not) or, with
``pipeline_mesh``, on a ``(pipe, data)`` or ``(pipe, model)`` mesh
(``parallel.pipeline``, ``n_micro`` microbatches).  Each data rank runs its
rows of the batch; the loss is the global token-weighted mean, as GSPMD
computes it over the whole batch: the masked NLL and the token count are
summed over ``data``, and so are the gradients (an FSDP leaf's onto its
owner).  The clip's global norm is the norm of the logical arrays: a
leaf's pieces are summed over the axes that shard it (``model``, and the
axis whose one rank holds it: ``data`` under FSDP, ``pipe`` under PP), a
replicated leaf counts once; so the clip decides the same on every rank.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..core.config import VisualCLAConfig

from ..checkpoint.from_jax import jax_key
from ..models.visualcla import multimodal_embeds
from ..ops.attention import attention_impl_scope
from ..parallel import tp
from ..parallel.sharding import DATA, is_placed, norm_axes

IGNORE_INDEX = -100
Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """Carried training state: ``params`` name -> the model's own parameter,
    ``opt_state`` the optimizer's (``Optimizer.init``), ``step`` the count."""

    params: Params
    opt_state: dict
    step: int


def masked_nll(logits: torch.Tensor, labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of the next-token NLL over the non-ignored positions, their
    count) of (B, S, V) logits against (B, S) labels (HF: shift inside,
    ignore -100); in fp32 (fp64 for fp64 logits)."""
    logits = logits[:, :-1]
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    targets = labels[:, 1:].long()
    mask = (targets != IGNORE_INDEX).float()
    safe = torch.where(targets == IGNORE_INDEX, torch.zeros_like(targets), targets)
    nll = -torch.log_softmax(logits, dim=-1).gather(-1, safe[..., None])[..., 0]
    return (nll * mask).sum(), mask.sum()


def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy of (B, S, V) logits against (B, S) labels,
    the mean over the non-ignored positions (an all-ignored batch gives 0)."""
    total, count = masked_nll(logits, labels)
    return total / count.clamp(min=1.0)


def _step_mesh(model: nn.Module, pipeline_mesh):
    """The mesh a step runs on: ``pipeline_mesh``, else the model's own."""
    return pipeline_mesh if pipeline_mesh is not None else getattr(model, "mesh", None)


def data_rows(batch: Mapping, data: Optional[tp.Axis]) -> dict:
    """This data rank's rows of a global batch (all of it without a
    ``data`` axis of more than one rank)."""
    if data is None or data.size == 1:
        return dict(batch)
    B = batch["input_ids"].shape[0]
    if B % data.size:
        raise ValueError(f"batch {B} must be divisible by data={data.size}")
    w = B // data.size
    rows = slice(data.rank * w, (data.rank + 1) * w)
    return {k: (None if v is None else v[rows]) for k, v in batch.items()}


def _local_logits(model: nn.Module, cfg: VisualCLAConfig, input_ids, attention_mask,
                  img_start_pos, pixel_values, remat: bool, pipeline_mesh,
                  n_micro: int) -> torch.Tensor:
    with attention_impl_scope("xla"):
        embeds = multimodal_embeds(model, cfg, input_ids, img_start_pos, pixel_values,
                                   remat=remat)
        positions = (attention_mask.long().cumsum(-1) - 1).clamp(min=0)
        if pipeline_mesh is not None:
            from ..parallel.pipeline import stack_forward

            hidden = stack_forward(model.text, cfg.text_config, embeds, positions, None,
                                   attention_mask.bool(), 0, pipeline_mesh, n_micro, remat)
        else:
            hidden, _ = model.text(embeds, positions, None, attention_mask.bool(), 0,
                                   remat=remat)
        return model.text.logits(hidden)


def train_forward_logits(model: nn.Module, cfg: VisualCLAConfig, input_ids: torch.Tensor,
                         attention_mask: torch.Tensor, img_start_pos,
                         pixel_values: Optional[torch.Tensor], remat: bool = False,
                         pipeline_mesh=None, n_micro: int = 1) -> torch.Tensor:
    """The full multimodal forward for training: (B, S) -> (B, S, V) fp32
    logits, cache-free, with dense attention pinned on the vision side (a
    training forward never reaches kernel B2u, ``VISUALCLA_VIT_ATTN`` or
    not).  Positions are cumsum(mask) - 1 clamped at 0.  ``pipeline_mesh``:
    the decoder stack runs GPipe over its ``pipe`` axis (``n_micro``
    microbatches; B divisible by n_micro x data), each data rank its rows,
    and the logits are gathered back whole."""
    if pipeline_mesh is None:
        return _local_logits(model, cfg, input_ids, attention_mask, img_start_pos,
                             pixel_values, remat, None, 1)
    from ..parallel.pipeline import check_batch

    data = tp.axis(pipeline_mesh, DATA)
    n_data = data.size if data is not None else 1
    check_batch(input_ids.shape[0], n_micro, n_data)
    b = data_rows({"input_ids": input_ids, "attention_mask": attention_mask,
                   "img_start_pos": img_start_pos, "pixel_values": pixel_values}, data)
    logits = _local_logits(model, cfg, b["input_ids"], b["attention_mask"], b["img_start_pos"],
                           b["pixel_values"], remat, pipeline_mesh, n_micro)
    return tp.gather_rows_from_data(logits, data.group, n_data) if n_data > 1 else logits


def batch_to_device(model: nn.Module, batch: Mapping) -> dict:
    """A batch of numpy arrays or tensors (``train.data.DataLoader``'s keys)
    on the model's device: ids, mask and labels as int64, pixels in the
    model's float dtype, ``img_start_pos`` kept on the host (numpy) unless it
    is a tensor on the device already."""
    ref = model.projection.weight
    out = {k: torch.as_tensor(np.asarray(batch[k]) if not isinstance(batch[k], torch.Tensor)
                              else batch[k]).to(ref.device, torch.int64)
           for k in ("input_ids", "attention_mask", "labels")}
    pos = batch["img_start_pos"]
    if not (isinstance(pos, torch.Tensor) and pos.device == ref.device):
        pos = np.asarray(pos.cpu() if isinstance(pos, torch.Tensor) else pos)
    out["img_start_pos"] = pos
    pix = batch.get("pixel_values")
    out["pixel_values"] = (None if pix is None
                           else torch.as_tensor(pix).to(ref.device, ref.dtype))
    return out


def loss_fn(model: nn.Module, cfg: VisualCLAConfig, batch: Mapping,
            remat: bool = False) -> torch.Tensor:
    """The training loss of one batch (any device or dtype it arrives in)."""
    b = batch_to_device(model, batch)
    logits = train_forward_logits(model, cfg, b["input_ids"], b["attention_mask"],
                                  b["img_start_pos"], b["pixel_values"], remat=remat)
    return causal_lm_loss(logits, b["labels"])


def step_loss(model: nn.Module, cfg: VisualCLAConfig, batch: Mapping, remat: bool = False,
              pipeline_mesh=None, n_micro: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (this rank's differentiable share of the loss, the loss) of a global
    batch.  Unmeshed: both the loss.  Over a mesh with a ``data`` axis: the
    rank's rows' masked NLL over the global token count, and their sum over
    ``data`` (the global token-weighted mean)."""
    mesh = _step_mesh(model, pipeline_mesh)
    if mesh is None:
        loss = loss_fn(model, cfg, batch, remat=remat)
        return loss, loss.detach()
    data = tp.axis(mesh, DATA)
    if pipeline_mesh is not None:
        from ..parallel.pipeline import check_batch

        check_batch(batch["input_ids"].shape[0], n_micro, data.size if data else 1)
    b = batch_to_device(model, data_rows(batch, data))
    logits = _local_logits(model, cfg, b["input_ids"], b["attention_mask"], b["img_start_pos"],
                           b["pixel_values"], remat, pipeline_mesh, n_micro)
    total, count = masked_nll(logits, b["labels"])
    if data is None:
        loss = total / count.clamp(min=1.0)
        return loss, loss.detach()
    count = tp.reduce_from_model(count.detach().clone(), data.group)
    share = total / count.clamp(min=1.0)
    return share, tp.reduce_from_model(share.detach().clone(), data.group)


@torch.no_grad()
def reduce_data_grads(params: Params, grads: Params, mesh) -> None:
    """Sum the gradients over ``mesh``'s ``data`` axis, in place, one
    all-reduce a dtype; an FSDP leaf's gradient was summed onto its owner
    already (``parallel.fsdp``)."""
    data = tp.axis(mesh, DATA)
    if data is None:
        return
    gs = [grads[n] for n, p in params.items()
          if getattr(p, "owner", (None,))[0] is None or p.owner[0].name != DATA]
    for dtype in sorted({g.dtype for g in gs}, key=str):
        part = [g for g in gs if g.dtype == dtype]
        flat = tp.reduce_from_model(torch.cat([g.reshape(-1) for g in part]), data.group)
        for g, v in zip(part, flat.split([g.numel() for g in part])):
            g.copy_(v.view_as(g))


# ---------------------------------------------------------------------------
# trainable-subset predicates (the reference's two training stages)
# ---------------------------------------------------------------------------

def stage1_trainable(path: tuple) -> bool:
    """Pretraining stage: resampler + projection (+ vision tower); LLM frozen."""
    return path[0] in ("resampler", "projection", "vision")


def stage2_trainable(path: tuple) -> bool:
    """Instruction-SFT stage: everything trains."""
    return True


def param_paths(model: nn.Module) -> Dict[str, tuple]:
    """Module parameter name -> its JAX leaf path (``("text", "layers",
    "q_proj", "lora_A")``)."""
    return {n: tuple(jax_key(n).split("/")) for n, _ in model.named_parameters()}


def _params_of(params: Union[nn.Module, Params]) -> Params:
    return dict(params.named_parameters()) if isinstance(params, nn.Module) else dict(params)


def _is_float(t: torch.Tensor) -> bool:
    return t.is_floating_point() or t.is_complex()


# ---------------------------------------------------------------------------
# the optimizer: optax.chain(clip_by_global_norm, adamw) on dicts of tensors
# ---------------------------------------------------------------------------

def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0
                                 ) -> Callable[[int], float]:
    """optax's schedule: linear from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then cosine to ``end_value`` at ``decay_steps``."""
    alpha = end_value / peak_value if peak_value else 0.0
    span = decay_steps - warmup_steps
    if span <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed warmup_steps {warmup_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, span)
        cosine = 0.5 * (1 + math.cos(math.pi * c / span))
        return peak_value * ((1 - alpha) * cosine + alpha)

    return schedule


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(learning_rate, b1,
    b2, eps, weight_decay))`` over dicts of tensors, updating in place.  The
    clip scales by ``max_norm / norm`` when ``norm >= max_norm`` (as optax:
    ``(g / norm) * max_norm``); the moments are kept in each parameter's
    dtype; the learning rate is read at the count before the step, so a
    warmup's first step has lr ``init_value``."""

    learning_rate: Union[float, Callable[[int], float]]
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0

    def init(self, params: Union[nn.Module, Params]) -> dict:
        params = _params_of(params)
        return {"count": 0,
                "mu": {n: torch.zeros_like(p) for n, p in params.items()},
                "nu": {n: torch.zeros_like(p) for n, p in params.items()}}

    def lr(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count) if callable(lr) else lr)

    @torch.no_grad()
    def update_(self, params: Params, grads: Params, state: dict) -> torch.Tensor:
        """Clip ``grads`` (consumed), step ``state`` and ``params`` in place
        with multi-tensor (``torch._foreach_*``) ops, a few launches for the
        whole tree; -> the global norm of the unclipped gradients (fp32)."""
        names = list(params)
        if not names:
            return torch.zeros(())
        ps = [params[n] for n in names]
        gs = [grads[n] for n in names]
        mus = [state["mu"][n] for n in names]
        nus = [state["nu"][n] for n in names]
        norm = global_norm(ps, gs)
        if bool(norm >= self.grad_clip):  # optax: (g / norm) * max_norm, norm in g's dtype
            for dtype in {g.dtype for g in gs}:
                part = [g for g in gs if g.dtype == dtype]
                torch._foreach_div_(part, float(norm.to(dtype)))
                torch._foreach_mul_(part, self.grad_clip)
        count = state["count"]
        lr = self.lr(count)
        count_inc = count + 1
        torch._foreach_mul_(mus, self.b1)
        torch._foreach_add_(mus, gs, alpha=1 - self.b1)
        torch._foreach_mul_(nus, self.b2)
        torch._foreach_addcmul_(nus, gs, gs, value=1 - self.b2)
        denom = torch._foreach_div(nus, 1 - self.b2 ** count_inc)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mus, 1 - self.b1 ** count_inc)
        torch._foreach_div_(upd, denom)
        del denom
        if self.weight_decay:
            torch._foreach_add_(upd, ps, alpha=self.weight_decay)
        torch._foreach_add_(ps, upd, alpha=-lr)
        state["count"] = count_inc
        return norm


def global_norm(params, grads) -> torch.Tensor:
    """The global norm of ``grads`` as logical arrays: each leaf's
    squares summed over the axes whose pieces make it (``norm_axes`` of its
    parameter), a replicated leaf's once."""
    # fp32 (fp64 for an fp64 tree)
    dtype = torch.float64 if any(g.dtype == torch.float64 for g in grads) else torch.float32
    if not any(is_placed(p) for p in params):
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads, 2, dtype=dtype)))
    buckets = {}
    for p, g in zip(params, grads):
        axes = norm_axes(p)
        buckets.setdefault(tuple(a.name for a in axes), (axes, []))[1].append(g)
    total = None
    for key in sorted(buckets):
        axes, gs = buckets[key]
        sq = torch.stack(torch._foreach_norm(gs, 2, dtype=dtype)).square().sum()
        for ax in axes:
            sq = tp.reduce_from_model(sq, ax.group)
        total = sq if total is None else total + sq
    return total.sqrt()


def make_optimizer(learning_rate: float = 1e-4, weight_decay: float = 0.0, b1: float = 0.9,
                   b2: float = 0.999, grad_clip: float = 1.0, warmup_steps: int = 0,
                   total_steps: int = 10_000, schedule: str = "cosine") -> Optimizer:
    """The JAX package's optimizer: with ``schedule="cosine"`` a warmup from 0
    to ``learning_rate`` and a cosine decay to 0 at ``total_steps`` (total at
    least 2, the warmup between 1 and a tenth of it); else a constant rate."""
    if schedule == "cosine":
        total = max(total_steps, 2)
        warmup = min(max(warmup_steps, 1), max(total // 10, 1))
        lr = warmup_cosine_decay_schedule(0.0, learning_rate, warmup, total)
    else:
        lr = learning_rate
    return Optimizer(lr, b1=b1, b2=b2, weight_decay=weight_decay, grad_clip=grad_clip)


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------

def init_train_state(params: Union[nn.Module, Params], optimizer: Optimizer) -> TrainState:
    """A state over ``params`` (a model: all its parameters)."""
    params = _params_of(params)
    return TrainState(params=params, opt_state=optimizer.init(params), step=0)


def _grads(params: Params) -> Params:
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p))
            for n, p in params.items()}


def make_train_step(model: nn.Module, cfg: VisualCLAConfig, optimizer: Optimizer,
                    trainable: Optional[Callable[[tuple], bool]] = None, remat: bool = False,
                    pipeline_mesh=None, n_micro: int = 1):
    """``train_step(state, batch) -> (state, metrics)`` over ``model``: every
    parameter of ``state.params`` is differentiated, the gradients outside
    ``trainable`` are zeroed, and the optimizer steps them all.  ``batch``
    keys: input_ids, attention_mask, labels (B, S), img_start_pos (B,),
    pixel_values (B, 3, H, W) or None.  Metrics: loss, grad_norm (of the
    masked gradients, before the clip).  Over a mesh (the model's, or
    ``pipeline_mesh`` with ``n_micro`` microbatches) every rank passes the
    same global batch."""
    model.text.require("training")
    paths = param_paths(model)
    mesh = _step_mesh(model, pipeline_mesh)

    def train_step(state: TrainState, batch):
        ints = [(n, str(p.dtype)) for n, p in state.params.items() if not _is_float(p)]
        if ints:
            raise TypeError(
                f"integer-dtype leaves {ints[:3]} cannot be differentiated: make_train_step "
                "differentiates the whole tree; train a quantized base with "
                "make_train_step_subset and the base frozen")
        for p in model.parameters():
            p.requires_grad_(False)
        for p in state.params.values():
            p.requires_grad_(True)
            p.grad = None
        share, loss = step_loss(model, cfg, batch, remat, pipeline_mesh, n_micro)
        share.backward()
        grads = _grads(state.params)
        if mesh is not None:
            reduce_data_grads(state.params, grads, mesh)
        if trainable is not None:
            for n, g in grads.items():
                if not trainable(paths[n]):
                    g.zero_()
        gnorm = optimizer.update_(state.params, grads, state.opt_state)
        return (TrainState(params=state.params, opt_state=state.opt_state, step=state.step + 1),
                {"loss": loss, "grad_norm": gnorm})

    return train_step


def partition_params(params: Union[nn.Module, Params], trainable: Callable[[tuple], bool]
                     ) -> Tuple[Params, Params]:
    """-> (train, frozen): the parameters split by ``trainable`` over their
    JAX paths, disjoint, in the model's order; ``requires_grad`` is set to
    match.  Raises if an integer-dtype leaf lands in the trainable part."""
    if not isinstance(params, nn.Module):
        raise TypeError("partition_params takes the model (its names map to JAX paths)")
    paths = param_paths(params)
    train, frozen = {}, {}
    for n, p in params.named_parameters():
        (train if trainable(paths[n]) else frozen)[n] = p
    bad = [("/".join(paths[n]), str(p.dtype)) for n, p in train.items() if not _is_float(p)]
    if bad:
        raise ValueError(
            f"integer-dtype leaves in the TRAINABLE partition {bad} — "
            "quantized weights cannot train; keep modules_to_save leaves "
            "(embed_tokens/lm_head/...) unquantized for QLoRA")
    for p in frozen.values():
        p.requires_grad_(False)
    for p in train.values():
        p.requires_grad_(True)
    return train, frozen


def merge_params(train: Params, frozen: Params) -> Params:
    """Inverse of ``partition_params``: one dict of both parts."""
    return {**frozen, **train}


def make_train_step_subset(model: nn.Module, cfg: VisualCLAConfig, optimizer: Optimizer,
                           trainable: Callable[[tuple], bool], remat: bool = False,
                           pipeline_mesh=None, n_micro: int = 1):
    """Like ``make_train_step``, but ``state.params`` holds only the trainable
    partition (``partition_params``): gradients and optimizer state exist for
    it alone, and the frozen partition (an int8 or int4 base included)
    never requires grad.  ``train_step(state, frozen, batch) -> (state,
    metrics)``; a mesh as ``make_train_step``'s."""
    model.text.require("training")
    mesh = _step_mesh(model, pipeline_mesh)

    def train_step(state: TrainState, frozen: Params, batch):
        for p in frozen.values():
            p.requires_grad_(False)
        for p in state.params.values():
            p.requires_grad_(True)
            p.grad = None
        share, loss = step_loss(model, cfg, batch, remat, pipeline_mesh, n_micro)
        share.backward()
        grads = _grads(state.params)
        if mesh is not None:
            reduce_data_grads(state.params, grads, mesh)
        gnorm = optimizer.update_(state.params, grads, state.opt_state)
        return (TrainState(params=state.params, opt_state=state.opt_state, step=state.step + 1),
                {"loss": loss, "grad_norm": gnorm})

    return train_step
