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
QLoRA form: the frozen partition, the int8 base included, never requires
grad.  ``make_optimizer`` is optax's ``chain(clip_by_global_norm,
adamw)`` over such dicts (``Optimizer``).  The forward is cache-free and
runs dense attention only: no hand kernel has a backward, and the JAX
package's training runs no Pallas kernel either.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..core.config import VisualCLAConfig

from ..api import _not_ported
from ..checkpoint.from_jax import jax_key
from ..models.visualcla import multimodal_embeds
from ..ops.attention import attention_impl_scope

IGNORE_INDEX = -100
Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """Carried training state: ``params`` name -> the model's own parameter,
    ``opt_state`` the optimizer's (``Optimizer.init``), ``step`` the count."""

    params: Params
    opt_state: dict
    step: int


def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy of (B, S, V) logits against (B, S) labels,
    the mean over the non-ignored positions (HF: shift inside, ignore -100;
    an all-ignored batch gives 0)."""
    logits = logits[:, :-1].float()
    targets = labels[:, 1:].long()
    mask = (targets != IGNORE_INDEX).float()
    safe = torch.where(targets == IGNORE_INDEX, torch.zeros_like(targets), targets)
    nll = -torch.log_softmax(logits, dim=-1).gather(-1, safe[..., None])[..., 0]
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


def train_forward_logits(model: nn.Module, cfg: VisualCLAConfig, input_ids: torch.Tensor,
                         attention_mask: torch.Tensor, img_start_pos,
                         pixel_values: Optional[torch.Tensor], remat: bool = False,
                         pipeline_mesh=None, n_micro: int = 1) -> torch.Tensor:
    """The full multimodal forward for training: (B, S) -> (B, S, V) fp32
    logits, cache-free, with dense attention pinned on the vision side (a
    training forward never reaches kernel B2u, ``VISUALCLA_VIT_ATTN`` or
    not).  Positions are cumsum(mask) - 1 clamped at 0."""
    if pipeline_mesh is not None:
        raise _not_ported("pipeline-parallel training", "17: training over a mesh")
    with attention_impl_scope("xla"):
        embeds = multimodal_embeds(model, cfg, input_ids, img_start_pos, pixel_values,
                                   remat=remat)
        positions = (attention_mask.long().cumsum(-1) - 1).clamp(min=0)
        hidden, _ = model.text(embeds, positions, None, attention_mask.bool(), 0, remat=remat)
        return model.text.logits(hidden)


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
        norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(gs, 2, dtype=torch.float32)))
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
    masked gradients, before the clip)."""
    if pipeline_mesh is not None:
        raise _not_ported("pipeline-parallel training", "17: training over a mesh")
    paths = param_paths(model)

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
        loss = loss_fn(model, cfg, batch, remat=remat)
        loss.backward()
        grads = _grads(state.params)
        if trainable is not None:
            for n, g in grads.items():
                if not trainable(paths[n]):
                    g.zero_()
        gnorm = optimizer.update_(state.params, grads, state.opt_state)
        return (TrainState(params=state.params, opt_state=state.opt_state, step=state.step + 1),
                {"loss": loss.detach(), "grad_norm": gnorm})

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
    it alone, and the frozen partition (the int8 base of QLoRA included)
    never requires grad.  ``train_step(state, frozen, batch) -> (state,
    metrics)``."""
    if pipeline_mesh is not None:
        raise _not_ported("pipeline-parallel training", "17: training over a mesh")

    def train_step(state: TrainState, frozen: Params, batch):
        for p in frozen.values():
            p.requires_grad_(False)
        for p in state.params.values():
            p.requires_grad_(True)
            p.grad = None
        loss = loss_fn(model, cfg, batch, remat=remat)
        loss.backward()
        gnorm = optimizer.update_(state.params, _grads(state.params), state.opt_state)
        return (TrainState(params=state.params, opt_state=state.opt_state, step=state.step + 1),
                {"loss": loss.detach(), "grad_norm": gnorm})

    return train_step
