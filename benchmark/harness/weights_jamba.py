"""Seeded random weights of a Jamba configuration, each tensor drawn when it
is read.

A 52B-parameter tower is 103 GB in bf16, more than the card holds, so it is
never drawn whole: the text tower is a ``Mapping`` from HF Jamba's tensor
names to tensors made on access, each by ``torch.randn`` from a generator
seeded with a key of (seed, name), in bf16 on the run's device.  The port's
loader reads it name by name and quantizes each tensor on the card as it
arrives; the plain reference reads the same names again, layer by layer,
and gets the same numbers.  The vision side is small and drawn whole, per
tensor in the same way, under ``harness/weights.py``'s names and kinds.

Kinds: "w" N(0, 0.02^2) (every matrix, the embedding, biases); "norm"
1 + N(0, 0.1^2) (norm weights and Mamba's skip D, so a dropped one shows);
"conv" N(0, 0.3^2) (the depthwise conv's 4 taps and bias: PyTorch's Conv1d
scale at 4 inputs a channel); "A_log" log(1..N) + N(0, 0.1^2) (Mamba's S4D
real init, perturbed); "dt_bias" the inverse softplus of a dt drawn
log-uniform in [1e-3, 1e-1] (Mamba's init, arXiv:2312.00752).  With those
the recurrence keeps state over hundreds of tokens, so a state lost at a
chunk boundary shows in the logits.
"""
from __future__ import annotations

import hashlib
import math
from collections.abc import Mapping
from typing import Dict, List, Tuple

import torch

from . import weights

STD, NORM_STD, CONV_STD, A_LOG_STD = weights.STD, weights.NORM_STD, 0.3, 0.1
DT_MIN, DT_MAX = 1e-3, 1e-1


def layer_kinds(t: dict) -> List[Tuple[str, int]]:
    """(mixer, experts) per layer: ``JambaConfig.layers_block_type`` /
    ``layers_num_experts``."""
    return [("attention" if i % t["attn_layer_period"] == t["attn_layer_offset"] else "mamba",
             t["num_experts"] if i % t["expert_layer_period"] == t["expert_layer_offset"] else 1)
            for i in range(t["num_hidden_layers"])]


def dt_rank(t: dict) -> int:
    r = t.get("mamba_dt_rank", "auto")
    return -(-t["hidden_size"] // 16) if r == "auto" else int(r)


def layer_spec(t: dict, i: int) -> List[Tuple[str, tuple, str]]:
    """Layer ``i``'s tensors: [(HF name, shape, kind)]."""
    H, I, E = t["hidden_size"], t["intermediate_size"], t["num_experts"]
    N, Nkv = t["num_attention_heads"], t["num_key_value_heads"]
    hd, D, S, R = H // N, t["mamba_expand"] * H, t["mamba_d_state"], dt_rank(t)
    kind, n_exp = layer_kinds(t)[i]
    p = f"model.layers.{i}."
    out = [(p + "input_layernorm.weight", (H,), "norm"),
           (p + "pre_ff_layernorm.weight", (H,), "norm")]
    if kind == "attention":
        out += [(p + "self_attn.q_proj.weight", (N * hd, H), "w"),
                (p + "self_attn.k_proj.weight", (Nkv * hd, H), "w"),
                (p + "self_attn.v_proj.weight", (Nkv * hd, H), "w"),
                (p + "self_attn.o_proj.weight", (H, N * hd), "w")]
    else:
        m = p + "mamba."
        out += [(m + "in_proj.weight", (2 * D, H), "w"),
                (m + "conv1d.weight", (D, 1, t["mamba_d_conv"]), "conv"),
                (m + "x_proj.weight", (R + 2 * S, D), "w"),
                (m + "dt_proj.weight", (D, R), "w"), (m + "dt_proj.bias", (D,), "dt_bias"),
                (m + "A_log", (D, S), "A_log"), (m + "D", (D,), "norm"),
                (m + "out_proj.weight", (H, D), "w"),
                (m + "dt_layernorm.weight", (R,), "norm"),
                (m + "b_layernorm.weight", (S,), "norm"),
                (m + "c_layernorm.weight", (S,), "norm")]
        if t.get("mamba_conv_bias", True):
            out.append((m + "conv1d.bias", (D,), "conv"))
    f = p + "feed_forward."
    if n_exp > 1:
        out.append((f + "router.weight", (E, H), "w"))
        for e in range(E):
            out += [(f"{f}experts.{e}.gate_proj.weight", (I, H), "w"),
                    (f"{f}experts.{e}.up_proj.weight", (I, H), "w"),
                    (f"{f}experts.{e}.down_proj.weight", (H, I), "w")]
    else:
        out += [(f + "gate_proj.weight", (I, H), "w"), (f + "up_proj.weight", (I, H), "w"),
                (f + "down_proj.weight", (H, I), "w")]
    return out


def text_spec(t: dict) -> List[Tuple[str, tuple, str]]:
    H, V = t["hidden_size"], t["vocab_size"]
    out = [("model.embed_tokens.weight", (V, H), "w")]
    for i in range(t["num_hidden_layers"]):
        out += layer_spec(t, i)
    return out + [("model.final_layernorm.weight", (H,), "norm"), ("lm_head.weight", (V, H), "w")]


def key(seed: int, name: str) -> int:
    """The generator's seed for one tensor of one run."""
    return int.from_bytes(hashlib.sha256(f"{int(seed)}:{name}".encode()).digest()[:8],
                          "little") & (2 ** 63 - 1)


@torch.no_grad()
def draw(name: str, shape: tuple, kind: str, seed: int, device,
         dtype=torch.bfloat16) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(key(seed, name))
    if kind == "dt_bias":
        u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
        dt = torch.exp(u * (math.log(DT_MAX) - math.log(DT_MIN)) + math.log(DT_MIN))
        return (dt + torch.log(-torch.expm1(-dt))).to(dtype)
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32 if kind == "A_log"
                    else dtype)
    if kind == "w":
        return x.mul_(STD)
    if kind == "conv":
        return x.mul_(CONV_STD)
    if kind == "norm":
        return x.mul_(NORM_STD).add_(1.0)
    if kind == "A_log":
        n = torch.arange(1, shape[-1] + 1, device=device, dtype=torch.float32)
        return (torch.log(n) + A_LOG_STD * x).to(dtype)
    raise ValueError(f"unknown kind {kind!r}")


class Drawn(Mapping):
    """name -> tensor, drawn when read (a new tensor every read)."""

    def __init__(self, spec, seed: int, device, dtype=torch.bfloat16):
        self.spec = {n: (s, k) for n, s, k in spec}
        self.seed, self.device, self.dtype = seed, device, dtype

    def __getitem__(self, name: str) -> torch.Tensor:
        shape, kind = self.spec[name]
        return draw(name, shape, kind, self.seed, self.device, self.dtype)

    def __iter__(self):
        return iter(self.spec)

    def __len__(self) -> int:
        return len(self.spec)


def spec(cfg: dict) -> Dict[str, List[Tuple[str, tuple, str]]]:
    """Tower -> [(name, shape, kind)]; the text tower's from the whole
    configuration (its top-level keys)."""
    out = weights.spec({**cfg, "text_config": {"hidden_size": cfg["hidden_size"],
                                               "intermediate_size": 1, "num_hidden_layers": 0,
                                               "num_attention_heads": 1, "vocab_size": 1}})
    out["text"] = text_spec(cfg)
    return out


def make(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> Dict[str, Mapping]:
    """Tower -> name -> tensor: the text tower drawn on access (``Drawn``),
    the vision side drawn now, each tensor from its own key."""
    towers = spec(cfg)
    out: Dict[str, Mapping] = {"text": Drawn(towers.pop("text"), seed, device, dtype)}
    for tower, entries in towers.items():
        out[tower] = {n: draw(n, s, k, seed, device, dtype) for n, s, k in entries}
    return out
