"""The reference's HF state dicts <-> the JAX package's tree and this
package's modules (port of visualcla_tpu/checkpoint/mapping.py).

Key names follow the reference checkpoints:
- LLaMA:      ``model.layers.N...`` (``text_encoder/``)
- CLIP ViT:   ``vision_model.encoder.layers.N...`` (``vision_encoder/``)
- resampler:  ``visual_resampler.encoder.layer.N.crossattention...`` with the
  reference's triple-d ``query_embeddding`` typo
- projector:  ``image_projection_layer.{weight,bias}``

Each table below lists, in the JAX tree's order, a reference key (``{}`` for
the layer index), its JAX leaf and how it is laid out there: ``"t"`` a
torch ``nn.Linear`` weight (out, in) stored (in, out), ``"patch"`` the
(H, 3, P, P) conv filter stored (3 P P, H), ``"query"`` the (1, Nq, H) query
table stored (Nq, H), ``""`` as it is.  Two directions read them:

- ``tower_tree_from_sd``: the JAX-layout tree (layers stacked on a leading
  axis), what ``convert_merged`` writes as a native checkpoint;
- ``iter_leaves``: one (JAX leaf, layer, tensor) at a time in the JAX
  orientation, which ``checkpoint.from_jax.leaf_to_state`` maps straight
  onto the modules (HF's (out, in) is the modules' own, so a text weight
  reaches the card as it was read).

``sd_from_tower_leaves`` inverts the tables for ``checkpoint.export``.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import torch

SD = Dict[str, torch.Tensor]

TEXT_KEYS = (
    ("model.embed_tokens.weight", "embed_tokens", ""),
    ("model.layers.{}.input_layernorm.weight", "layers/input_norm", ""),
    ("model.layers.{}.self_attn.q_proj.weight", "layers/q_proj", "t"),
    ("model.layers.{}.self_attn.k_proj.weight", "layers/k_proj", "t"),
    ("model.layers.{}.self_attn.v_proj.weight", "layers/v_proj", "t"),
    ("model.layers.{}.self_attn.o_proj.weight", "layers/o_proj", "t"),
    ("model.layers.{}.post_attention_layernorm.weight", "layers/post_norm", ""),
    ("model.layers.{}.mlp.gate_proj.weight", "layers/gate_proj", "t"),
    ("model.layers.{}.mlp.up_proj.weight", "layers/up_proj", "t"),
    ("model.layers.{}.mlp.down_proj.weight", "layers/down_proj", "t"),
    ("model.norm.weight", "final_norm", ""),
    ("lm_head.weight", "lm_head", "t"),
)


def _ln(ref: str, leaf: str) -> tuple:
    return ((ref + ".weight", leaf + "/weight", ""), (ref + ".bias", leaf + "/bias", ""))


def _lin(ref: str, leaf: str, bias: str) -> tuple:
    return ((ref + ".weight", leaf, "t"), (ref + ".bias", bias, ""))


_VL = "encoder.layers.{}."
VIT_KEYS = (
    ("embeddings.class_embedding", "class_embedding", ""),
    ("embeddings.patch_embedding.weight", "patch_embedding", "patch"),
    ("embeddings.position_embedding.weight", "position_embedding", ""),
    *_ln("pre_layrnorm", "pre_layernorm"),  # HF's typo'd attribute name
    *_ln(_VL + "layer_norm1", "layers/ln1"),
    *_lin(_VL + "self_attn.q_proj", "layers/q_proj", "layers/q_bias"),
    *_lin(_VL + "self_attn.k_proj", "layers/k_proj", "layers/k_bias"),
    *_lin(_VL + "self_attn.v_proj", "layers/v_proj", "layers/v_bias"),
    *_lin(_VL + "self_attn.out_proj", "layers/o_proj", "layers/o_bias"),
    *_ln(_VL + "layer_norm2", "layers/ln2"),
    *_lin(_VL + "mlp.fc1", "layers/fc1", "layers/fc1_bias"),
    *_lin(_VL + "mlp.fc2", "layers/fc2", "layers/fc2_bias"),
    *_ln("post_layernorm", "post_layernorm"),
)

_RX = "encoder.layer.{}.crossattention."
_RF = "encoder.layer.{}."
RESAMPLER_KEYS = (
    ("query_embeddding", "query_embedding", "query"),
    *_lin(_RX + "self.query", "layers/q_proj", "layers/q_bias"),
    *_lin(_RX + "self.key", "layers/k_proj", "layers/k_bias"),
    *_lin(_RX + "self.value", "layers/v_proj", "layers/v_bias"),
    *_lin(_RX + "output.dense", "layers/attn_out", "layers/attn_out_bias"),
    *_ln(_RX + "output.LayerNorm", "layers/attn_ln"),
    *_lin(_RF + "intermediate.dense", "layers/inter", "layers/inter_bias"),
    *_lin(_RF + "output.dense", "layers/out", "layers/out_bias"),
    *_ln(_RF + "output.LayerNorm", "layers/out_ln"),
    *_lin("pooler.dense", "pooler/weight", "pooler/bias"),  # optional
)

PROJECTION_KEYS = (("weight", "weight", "t"), ("bias", "bias", ""))

# tower -> (its table, the reference prefix)
TOWERS = {"text": (TEXT_KEYS, ""), "vision": (VIT_KEYS, "vision_model."),
          "resampler": (RESAMPLER_KEYS, "visual_resampler."),
          "projection": (PROJECTION_KEYS, "image_projection_layer.")}
_OPTIONAL = ("pooler/",)


def _to_jax(t: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "t":
        return t.t()
    if kind == "patch":
        return t.reshape(t.shape[0], -1).t()
    if kind == "query":
        return t[0]
    return t


def _from_jax(t: torch.Tensor, kind: str, patch_size: Optional[int]) -> torch.Tensor:
    if kind == "t":
        return t.t().contiguous()
    if kind == "patch":
        return t.t().reshape(t.shape[1], 3, patch_size, patch_size).contiguous()
    if kind == "query":
        return t[None]
    return t


def _ref_key(sd: SD, prefix: str, ref: str) -> str:
    key = prefix + ref
    if ref == "query_embeddding" and key not in sd:
        key = prefix + "query_embedding"  # a checkpoint without the typo
    return key


def num_layers(sd: SD, prefix: str, table) -> int:
    layered = [ref for ref, _, _ in table if "{}" in ref]
    if not layered:
        return 0
    fmt = prefix + layered[0]
    n = 0
    while fmt.format(n) in sd:
        n += 1
    return n


def iter_leaves(sd: SD, tower: str, prefix: Optional[str] = None, consume: bool = False
                ) -> Iterator[Tuple[str, Optional[int], torch.Tensor]]:
    """Yield (JAX leaf key, layer or None, tensor in the JAX orientation) for
    every tensor of one tower in ``sd``; ``consume`` pops each from ``sd`` as
    it goes, so a 7B text tower is not held twice."""
    table, default = TOWERS[tower]
    p = default if prefix is None else prefix
    L = num_layers(sd, p, table)
    get = sd.pop if consume else sd.__getitem__
    for ref, leaf, kind in table:
        key = f"{tower}/{leaf}"
        if leaf.startswith(_OPTIONAL) and p + ref not in sd:
            continue
        if "{}" in ref:
            for l in range(L):
                yield key, l, _to_jax(get(p + ref.format(l)), kind)
        else:
            yield key, None, _to_jax(get(_ref_key(sd, p, ref)), kind)


def tower_tree_from_sd(sd: SD, tower: str, prefix: Optional[str] = None,
                       consume: bool = False) -> Dict[str, torch.Tensor]:
    """One tower's JAX-layout leaves (flat keys without the tower, stacked
    layers), contiguous CPU tensors in the tree's order."""
    flat, stacks = {}, {}
    for key, layer, t in iter_leaves(sd, tower, prefix, consume):
        leaf = key.split("/", 1)[1]
        if layer is None:
            flat[leaf] = t.contiguous()
        else:
            stacks.setdefault(leaf, []).append(t)
            flat.setdefault(leaf, None)
    for leaf, ts in stacks.items():
        flat[leaf] = torch.stack(ts)
        ts.clear()
    return flat


def sd_from_tower_leaves(leaves: Dict[str, torch.Tensor], tower: str,
                         patch_size: Optional[int] = None) -> SD:
    """The inverse: one tower's flat JAX-layout leaves (keys without the
    tower; a layer leaf stacked or a list of its layers) -> the reference
    state dict, in the table's order."""
    table, p = TOWERS[tower]
    sd: SD = {}
    for ref, leaf, kind in table:
        if leaf not in leaves:
            if leaf.startswith(_OPTIONAL):
                continue
            raise KeyError(f"{tower}/{leaf}")
        t = leaves[leaf]
        if "{}" in ref:
            for l in range(len(t)):
                sd[p + ref.format(l)] = _from_jax(t[l], kind, patch_size)
        else:
            sd[p + ref] = _from_jax(t, kind, patch_size)
    return sd
