"""HF Jamba's tensor names -> the port's ``models.jamba.Jamba``, loaded one
tensor at a time.

``load_text_(text, sd, prefix)`` reads every name of ``sd`` once (a dict is
consumed entry by entry; any ``Mapping`` whose values are produced on
access will do, so a caller never holds the whole tower), moves the tensor
to the tower's device and puts it in place: a dense leaf copied, an int4
one (the layers' products, the experts, the head) quantized there, on the
device, and the per-row int8 embedding table the same.  So the bf16 peak is
one tensor above the tower at its tier.  Names, after ``prefix``:

- ``model.embed_tokens.weight``, ``lm_head.weight``,
  ``model.final_layernorm.weight``;
- ``model.layers.{l}.input_layernorm.weight`` / ``pre_ff_layernorm.weight``;
- ``.self_attn.{q,k,v,o}_proj.weight`` (attention layers);
- ``.mamba.{in_proj,x_proj,dt_proj,out_proj}.weight``, ``.mamba.dt_proj.bias``,
  ``.mamba.conv1d.{weight,bias}``, ``.mamba.A_log``, ``.mamba.D``,
  ``.mamba.{dt,b,c}_layernorm.weight`` (Mamba layers);
- ``.feed_forward.router.weight``, ``.feed_forward.experts.{e}.{gate,up,down}_proj.weight``
  (MoE layers), ``.feed_forward.{gate,up,down}_proj.weight`` (dense ones).
"""
from __future__ import annotations

import re
from typing import Mapping

import torch

from ..models.jamba import Experts, ExpertsInt4, Jamba
from ..ops.linear import Int4Linear, Int8Table, Linear
from ..ops.quantization import quantize, quantize_grouped

_LAYER = re.compile(r"model\.layers\.(\d+)\.(.+)$")
_EXPERT = re.compile(r"feed_forward\.experts\.(\d+)\.(gate|up|down)_proj\.weight$")
_MAMBA_PARAMS = {"conv1d.weight": "conv_weight", "conv1d.bias": "conv_bias", "A_log": "A_log",
                 "D": "D", "x_proj.weight": "x_proj.weight", "dt_proj.weight": "dt_proj.weight",
                 "dt_proj.bias": "dt_proj.bias", "dt_layernorm.weight": "dt_norm.weight",
                 "b_layernorm.weight": "b_norm.weight", "c_layernorm.weight": "c_norm.weight"}


def _put_linear(mod, t: torch.Tensor) -> None:
    """A (out, in) weight into a dense or int4 linear, where it lies."""
    if isinstance(mod, Int4Linear):
        wq = quantize_grouped(t.t(), group=2 * mod.q.shape[1])
        mod.q.copy_(wq["q"])
        mod.scale.copy_(wq["scale"])
    elif isinstance(mod, Linear):
        mod.weight.copy_(t)
    else:
        raise TypeError(f"no loader for {type(mod).__name__}")


def _put_param(root, path: str, t: torch.Tensor) -> None:
    *mods, leaf = path.split(".")
    for m in mods:
        root = getattr(root, m)
    p = getattr(root, leaf)
    p.copy_(t.reshape(p.shape))


def _put(text: Jamba, name: str, t: torch.Tensor) -> str:
    """One HF tensor into the tower; -> the name it filled (an expert's:
    ``...moe.<gate_up|down>.<e>.<gate|up|down>``)."""
    if name == "model.embed_tokens.weight":
        if isinstance(text.embed_tokens, Int8Table):
            wq = quantize(t, axis=-1)
            text.embed_tokens.q.copy_(wq["q"])
            text.embed_tokens.scale.copy_(wq["scale"])
        else:
            text.embed_tokens.copy_(t)
        return "embed_tokens"
    if name == "lm_head.weight":
        _put_linear(text.lm_head, t)
        return "lm_head"
    if name == "model.final_layernorm.weight":
        text.final_norm.weight.copy_(t)
        return "final_norm"
    m = _LAYER.match(name)
    if m is None:
        raise KeyError(f"not a Jamba tensor: {name!r}")
    i, rest = int(m.group(1)), m.group(2)
    layer = text.layers[i]
    where = f"layers.{i}."
    if rest in ("input_layernorm.weight", "pre_ff_layernorm.weight"):
        (layer.input_norm if rest.startswith("input") else layer.ff_norm).weight.copy_(t)
        return where + rest
    e = _EXPERT.match(rest)
    if e is not None:
        expert, proj = int(e.group(1)), e.group(2)
        mod = layer.moe.down if proj == "down" else layer.moe.gate_up
        col0 = layer.moe.I if proj == "up" else 0
        if isinstance(mod, ExpertsInt4):
            mod.put(expert, t, col0)
        elif isinstance(mod, Experts):
            mod.weight[expert, col0:col0 + t.shape[0]] = t
        return where + rest
    if rest == "feed_forward.router.weight":
        layer.moe.router.weight.copy_(t)
        return where + rest
    if rest.startswith("feed_forward."):
        _put_linear(getattr(layer, rest.split(".")[1]), t)
        return where + rest
    if rest.startswith("self_attn."):
        _put_linear(getattr(layer, rest.split(".")[1]), t)
        return where + rest
    if rest.startswith("mamba."):
        sub = rest[len("mamba."):]
        if sub in ("in_proj.weight", "out_proj.weight"):
            _put_linear(getattr(layer.mamba, sub.split(".")[0]), t)
        else:
            _put_param(layer.mamba, _MAMBA_PARAMS[sub], t)
        return where + rest
    raise KeyError(f"not a Jamba tensor: {name!r}")


def expected_names(text: Jamba) -> set:
    """Every HF name the tower needs."""
    cfg = text.cfg
    out = {"model.embed_tokens.weight", "lm_head.weight", "model.final_layernorm.weight"}
    for i, layer in enumerate(text.layers):
        p = f"model.layers.{i}."
        out |= {p + "input_layernorm.weight", p + "pre_ff_layernorm.weight"}
        if layer.kind == "attention":
            out |= {f"{p}self_attn.{n}_proj.weight" for n in "qkvo"}
        else:
            out |= {p + "mamba." + n for n in ("in_proj.weight", "out_proj.weight",
                                               *_MAMBA_PARAMS)}
            if layer.mamba.conv_bias is None:
                out.discard(p + "mamba.conv1d.bias")
        if hasattr(layer, "moe"):
            out.add(p + "feed_forward.router.weight")
            out |= {f"{p}feed_forward.experts.{e}.{n}_proj.weight"
                    for e in range(cfg.num_experts) for n in ("gate", "up", "down")}
        else:
            out |= {f"{p}feed_forward.{n}_proj.weight" for n in ("gate", "up", "down")}
    return out


@torch.no_grad()
def load_text_(text: Jamba, sd: Mapping[str, torch.Tensor], prefix: str = "") -> None:
    """Fill ``text`` from HF-named tensors (see the module's docstring);
    raises on an unknown name or on a name the tower needs and ``sd``
    lacks."""
    p = text.final_norm.weight
    device, dtype = p.device, p.dtype
    pop = getattr(sd, "pop", None)
    seen = set()
    for key in list(sd.keys()):
        if not key.startswith(prefix):
            continue
        t = pop(key) if pop is not None else sd[key]
        name = key[len(prefix):]
        _put(text, name, t.to(device=device, dtype=dtype))
        seen.add(name)
        del t
    missing = sorted(expected_names(text) - seen)
    if missing:
        raise KeyError(f"the Jamba checkpoint lacks {missing[:5]} ({len(missing)} tensors)")
