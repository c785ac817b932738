"""Linear layers (port of visualcla_tpu/ops/linear.py and the matmul side of
visualcla_tpu/ops/quantization.py): dense, int8 and int4 weights.

Dense weights are stored as torch's ``(out, in)``; the checkpoint converter
transposes the JAX package's ``(in, out)`` leaves.  The quantized forms keep
the JAX numerics (``ops/quantization.py:q_matmul``):
- ``Int8Linear``: q (out, in) int8, scale (1, out) f32; ``x @ q`` in x's
  dtype, then times the scale rounded to x's dtype (plain torch: the JAX
  package leaves this product to XLA too);
- ``Int4Linear``: the v2 carrier q (G, gs/2, out) uint8 and scale (G, out)
  f32 in the JAX orientation; ``x @ W4`` through kernel B3
  (``ops.cuda.int4_matmul``), returned in x's dtype;
- ``Int8Table``: the per-row int8 embedding table, q (V, H), scale (V, 1).
- ``LoraLinear``: a LoRA adapter over a frozen dense, int8 or int4 base,
  ``base(x) + (x A) B * scale (+ bias)``, the low-rank path kept apart as
  the JAX package's ``{"w", "lora_A", "lora_B", "lora_scale"}`` leaf keeps it.
``forward_f32`` is the LM head's product: fp32 accumulation and fp32 out.
Every form but ``Int4Linear`` is differentiable (the training path): B3 has
no backward, so an int4 base raises when its input requires grad.
The layer kind is the module's type, as the JAX package tells a quantized
leaf by its structure.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .cuda.int4_matmul import int4_matmul
from .quantization import effective_group, q_take, quantize, quantize_grouped


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class _MmF32(torch.autograd.Function):
    """x (T, in) @ w (out, in)^T, both in one low-precision dtype on the card,
    accumulated and returned in fp32 without an fp32 copy of w; the backward
    runs its two products in that dtype on the rounded fp32 cotangent."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        return (g @ w if ctx.needs_input_grad[0] else None,
                g.t() @ x if ctx.needs_input_grad[1] else None)


def _mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """fp32-accumulated ``x @ w^T`` in fp32 for bf16 / fp16 CUDA tensors of
    any leading shape, differentiable when autograd needs it."""
    flat = x.reshape(-1, x.shape[-1])
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        y = _MmF32.apply(flat, w)
    else:
        y = torch.mm(flat, w.t(), out_dtype=torch.float32)
    return y.reshape(*x.shape[:-1], w.shape[0])


class Linear(nn.Module):
    """``y = x W^T (+ b)`` with an uninitialised weight built directly on
    ``device`` in ``dtype`` (weights come from a checkpoint or from
    ``models.visualcla.init_random_``); the bias starts at zero."""

    def __init__(self, in_features: int, out_features: int, bias: bool, *,
                 device=None, dtype=None):
        super().__init__()
        self.weight = _frozen(torch.empty(out_features, in_features, device=device, dtype=dtype))
        self.bias = (_frozen(torch.zeros(out_features, device=device, dtype=dtype))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)

    def forward_f32(self, x: torch.Tensor) -> torch.Tensor:
        """fp32-accumulated product in fp32 (the LM head; an fp64 input stays fp64)."""
        w = self.weight
        if x.dtype in (torch.float32, torch.float64):
            return F.linear(x, w.to(x.dtype))
        if x.is_cuda:  # fp32 accumulation and output without an fp32 copy of w
            return _mm_f32(x, w)
        return F.linear(x.float(), w.float())

    def partial(self, x: torch.Tensor, f32: bool = False, bias: bool = True) -> torch.Tensor:
        """A row-parallel shard's product (``parallel.tp.linear``): x's
        columns against this rank's rows of the weight, with the bias when
        ``bias``; ``finish`` follows the sum over the shards."""
        if f32:
            y = self.forward_f32(x)
            return y + self.bias.float() if bias and self.bias is not None else y
        return F.linear(x, self.weight, self.bias if bias else None)

    def finish(self, y: torch.Tensor) -> torch.Tensor:
        return y


class Int8Linear(nn.Module):
    """Per-output-channel int8 weight, no bias."""

    def __init__(self, in_features: int, out_features: int, *, device=None):
        super().__init__()
        self.q = _frozen(torch.empty(out_features, in_features, dtype=torch.int8, device=device))
        self.scale = _frozen(torch.empty(1, out_features, dtype=torch.float32, device=device))

    @classmethod
    def from_dense(cls, weight: torch.Tensor) -> "Int8Linear":
        """Quantize a dense (out, in) weight where it lies."""
        out_f, in_f = weight.shape
        mod = cls(in_f, out_f, device="meta")
        wq = quantize(weight.t(), axis=-2)  # the JAX (in, out) orientation
        mod.q = _frozen(wq["q"].t().contiguous())
        mod.scale = _frozen(wq["scale"])
        return mod

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.q.to(x.dtype)) * self.scale.to(x.dtype)

    def forward_f32(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.float32:
            y = F.linear(x, self.q.float())
        elif x.is_cuda:
            y = _mm_f32(x, self.q.to(x.dtype))
        else:
            y = F.linear(x.float(), self.q.float())
        return y * self.scale

    def partial(self, x: torch.Tensor, f32: bool = False, bias: bool = True) -> torch.Tensor:
        """A row-parallel shard's unscaled product; ``finish`` scales the sum
        (the per-column scale is the whole leaf's: it commutes with the sum)."""
        if not f32 or x.dtype == torch.float32:
            return F.linear(x, self.q.to(x.dtype))
        return _mm_f32(x, self.q.to(x.dtype)) if x.is_cuda else F.linear(x.float(), self.q.float())

    def finish(self, y: torch.Tensor) -> torch.Tensor:
        return y * self.scale.to(y.dtype)


class Int4Linear(nn.Module):
    """Grouped int4 weight (v2 carrier), no bias; the product is kernel B3."""

    def __init__(self, in_features: int, out_features: int, group: int, *, device=None):
        super().__init__()
        if in_features % group or group % 2:
            raise ValueError(f"group {group} must be even and divide in_features {in_features}")
        G = in_features // group
        self.q = _frozen(torch.empty(G, group // 2, out_features, dtype=torch.uint8,
                                     device=device))
        self.scale = _frozen(torch.empty(G, out_features, dtype=torch.float32, device=device))

    @classmethod
    def from_dense(cls, weight: torch.Tensor, group: int) -> "Int4Linear":
        out_f, in_f = weight.shape
        mod = cls(in_f, out_f, group, device="meta")
        wq = quantize_grouped(weight.t(), group=group)
        mod.q, mod.scale = _frozen(wq["q"]), _frozen(wq["scale"])
        return mod

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _refuse_int4_grad(x)
        return int4_matmul(x, self.q, self.scale)

    def forward_f32(self, x: torch.Tensor) -> torch.Tensor:
        _refuse_int4_grad(x)
        return int4_matmul(x, self.q, self.scale, out_dtype=torch.float32)

    def partial(self, x: torch.Tensor, f32: bool = False, bias: bool = True) -> torch.Tensor:
        """A row-parallel shard's product over its whole groups (B3)."""
        return self.forward_f32(x) if f32 else self(x)

    def finish(self, y: torch.Tensor) -> torch.Tensor:
        return y


def _refuse_int4_grad(x: torch.Tensor) -> None:
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError(
            "training over an int4 base is not ported (ROADMAP, open item 15: training "
            "over an int4 base: B3 has no backward, and the JAX package's Pallas B3 has "
            "no VJP either); train over a dense or int8 base")


class Int8Table(nn.Module):
    """Per-row int8 embedding table; lookups return f32."""

    def __init__(self, num: int, dim: int, *, device=None):
        super().__init__()
        self.q = _frozen(torch.empty(num, dim, dtype=torch.int8, device=device))
        self.scale = _frozen(torch.empty(num, 1, dtype=torch.float32, device=device))

    @classmethod
    def from_dense(cls, table: torch.Tensor) -> "Int8Table":
        mod = cls(*table.shape, device="meta")
        wq = quantize(table, axis=-1)
        mod.q, mod.scale = _frozen(wq["q"]), _frozen(wq["scale"])
        return mod

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return q_take({"q": self.q, "scale": self.scale}, ids)


class LoraLinear(nn.Module):
    """``base(x) + ((x @ A) @ B) * scale`` then ``+ bias``, in x's dtype, as
    the JAX package's ``linear`` computes a LoRA leaf (and adds the layer's
    bias after it).  ``base`` is a bias-free ``Linear``, ``Int8Linear`` or
    ``Int4Linear``; ``lora_A`` is (r, in) and ``lora_B`` (out, r), torch's
    orientation; ``lora_scale`` a f32 scalar."""

    def __init__(self, base: nn.Module, rank: int, *, bias: Optional[torch.Tensor] = None,
                 device=None, dtype=None):
        super().__init__()
        in_f, out_f = base_features(base)
        kw = dict(device=device, dtype=dtype)
        self.base = base
        self.lora_A = _frozen(torch.zeros(rank, in_f, **kw))
        self.lora_B = _frozen(torch.zeros(out_f, rank, **kw))
        self.lora_scale = _frozen(torch.ones((), dtype=torch.float32, device=device))
        # a Parameter moves as it is (its placement over a mesh with it)
        self.bias = bias if bias is None or isinstance(bias, nn.Parameter) else _frozen(bias)

    def lora_term(self, x: torch.Tensor) -> torch.Tensor:
        """``((x A) B) * scale`` in x's dtype."""
        down = F.linear(x, self.lora_A.to(x.dtype))
        return F.linear(down, self.lora_B.to(x.dtype)) * self.lora_scale.to(x.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        term = self.lora_term(x)  # first: the backward sums x's gradients in this order
        y = self.base(x) + term
        return y if self.bias is None else y + self.bias


def base_features(mod: nn.Module) -> Tuple[int, int]:
    """(in, out) of a dense, int8 or int4 linear: the whole layer's over a
    mesh (``parallel.tp.attach`` marks a sharded side), its own tensors'
    otherwise."""
    if isinstance(mod, Int4Linear):
        G, half, out_f = mod.q.shape
        in_f = G * half * 2
    else:
        w = mod.q if isinstance(mod, Int8Linear) else mod.weight
        in_f, out_f = w.shape[1], w.shape[0]
    tp = getattr(mod, "tp", None)
    if tp is not None:
        in_f *= tp.size if mod.tp_in else 1
        out_f *= tp.size if mod.tp_out else 1
    return in_f, out_f


def make_linear(in_features: int, out_features: int, quant: str = "none", *, device=None,
                dtype=None) -> nn.Module:
    """A bias-free text-tower linear of the given tier: dense, int8, or int4
    with group ``effective_group(in_features)`` (per-channel int8 where no
    group >= 8 divides in_features, as the JAX loader falls back)."""
    if quant == "none":
        return Linear(in_features, out_features, False, device=device, dtype=dtype)
    if quant == "int4":
        gs = effective_group(in_features)
        if gs is not None:
            return Int4Linear(in_features, out_features, gs, device=device)
    elif quant != "int8":
        raise ValueError(f"quant must be 'none', 'int8' or 'int4', got {quant!r}")
    return Int8Linear(in_features, out_features, device=device)


def quantize_linear(mod: Linear, quant: str) -> nn.Module:
    """The quantized form of a bias-free dense linear (its tier as ``make_linear``)."""
    w = mod.weight
    if quant == "int4":
        gs = effective_group(w.shape[1])
        if gs is not None:
            return Int4Linear.from_dense(w, gs)
    elif quant != "int8":
        raise ValueError(f"quant must be 'int8' or 'int4', got {quant!r}")
    return Int8Linear.from_dense(w)
