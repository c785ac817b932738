"""Model configuration dataclasses + readers for the reference's HF-config JSON schema.

The reference stores a composite ``VisualCLAConfig`` (reference:
models/visualcla/configuration_visualcla.py:10-40) holding plain-dict ``text_config``
(HF LlamaConfig), ``vision_config`` (HF CLIPVisionConfig) and
``visual_resampler_config`` (BERT-style, reference:
models/visualcla/modeling_visual_resampler.py:90-129).  We mirror the schema with frozen
dataclasses so configs are hashable (usable as jit static args) and provide
``from_hf_dict`` readers that accept the reference's ``config.json`` files unchanged.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Mapping, Optional


def _take(d: Mapping[str, Any], cls) -> dict:
    """Keep only keys that are fields of ``cls``."""
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


# text ``model_type`` values whose equations are LLaMA's (absent: LLaMA)
LLAMA_TYPES = ("llama", "mistral")


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Decoder config (schema-compatible with HF LlamaConfig JSON).  The
    reader refuses a ``model_type`` other than LLaMA's and Mistral's, and a
    ``rope_scaling`` or ``sliding_window`` that is set: this decoder has
    neither, and dropping them would serve another model."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = None
    max_position_embeddings: int = 2048
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    attention_bias: bool = False
    hidden_act: str = "silu"

    def __post_init__(self):
        if self.num_key_value_heads is None:
            object.__setattr__(self, "num_key_value_heads", self.num_attention_heads)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_attention_layers(self) -> int:
        """Every layer attends (``JambaConfig``'s attention layers are fewer)."""
        return self.num_hidden_layers

    @classmethod
    def from_hf_dict(cls, d: Mapping[str, Any]) -> "LlamaConfig":
        kind = d.get("model_type")
        if kind is not None and kind not in LLAMA_TYPES:
            raise ValueError(f"text model_type {kind!r}: the LLaMA reader takes "
                             f"{LLAMA_TYPES} (or none)")
        for key in ("rope_scaling", "sliding_window"):
            if d.get(key) is not None:
                raise ValueError(f"text config sets {key}={d[key]!r}: the LLaMA decoder has "
                                 f"no {key}")
        return cls(**_take(d, cls))


@dataclasses.dataclass(frozen=True)
class JambaConfig:
    """Jamba decoder config (HF ``JambaConfig``'s keys): layer ``i`` is
    attention where ``i % attn_layer_period == attn_layer_offset`` and Mamba
    otherwise; its feed-forward is a ``num_experts`` MoE (top
    ``num_experts_per_tok``) where ``i % expert_layer_period ==
    expert_layer_offset`` and a dense SiLU MLP otherwise
    (transformers/models/jamba/configuration_jamba.py:216-227)."""

    vocab_size: int = 65536
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    max_position_embeddings: int = 262144
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = False
    hidden_act: str = "silu"
    attn_layer_period: int = 8
    attn_layer_offset: int = 4
    expert_layer_period: int = 2
    expert_layer_offset: int = 1
    num_experts: int = 16
    num_experts_per_tok: int = 2
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_dt_rank: Any = "auto"
    mamba_conv_bias: bool = True
    mamba_proj_bias: bool = False
    model_type: str = "jamba"

    def __post_init__(self):
        if self.mamba_dt_rank == "auto":
            object.__setattr__(self, "mamba_dt_rank", -(-self.hidden_size // 16))
        for name in ("attn", "expert"):
            if getattr(self, f"{name}_layer_offset") >= getattr(self, f"{name}_layer_period"):
                raise ValueError(f"{name}_layer_offset must be below {name}_layer_period")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def mamba_inner(self) -> int:
        return self.mamba_expand * self.hidden_size

    @property
    def layers_block_type(self) -> tuple:
        return tuple("attention" if i % self.attn_layer_period == self.attn_layer_offset
                     else "mamba" for i in range(self.num_hidden_layers))

    @property
    def layers_num_experts(self) -> tuple:
        return tuple(self.num_experts if i % self.expert_layer_period == self.expert_layer_offset
                     else 1 for i in range(self.num_hidden_layers))

    @property
    def num_attention_layers(self) -> int:
        return self.layers_block_type.count("attention")

    @property
    def num_mamba_layers(self) -> int:
        return self.layers_block_type.count("mamba")

    @classmethod
    def from_hf_dict(cls, d: Mapping[str, Any]) -> "JambaConfig":
        if d.get("sliding_window") is not None:
            raise ValueError(f"text config sets sliding_window={d['sliding_window']!r}: the "
                             "Jamba tower's attention has no window")
        return cls(**_take(d, cls))


def text_config_from_hf_dict(d: Mapping[str, Any]):
    """The text tower's config by its ``model_type``: Jamba's, or LLaMA's."""
    if d.get("model_type") == "jamba":
        return JambaConfig.from_hf_dict(d)
    return LlamaConfig.from_hf_dict(d)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """CLIP vision tower config (schema-compatible with HF CLIPVisionConfig JSON)."""

    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"
    projection_dim: int = 768  # unused by VisualCLA but present in the JSON

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1  # + CLS

    @classmethod
    def from_hf_dict(cls, d: Mapping[str, Any]) -> "ViTConfig":
        return cls(**_take(d, cls))


@dataclasses.dataclass(frozen=True)
class ResamplerConfig:
    """Visual resampler config.

    Defaults mirror the reference class defaults
    (models/visualcla/modeling_visual_resampler.py:90-129); the shipped VisualCLA
    checkpoint uses hidden_size=1024, num_hidden_layers=6, num_query_tokens=64.
    """

    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-12
    num_query_tokens: int = 32
    add_pooling_layer: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def from_hf_dict(cls, d: Mapping[str, Any]) -> "ResamplerConfig":
        return cls(**_take(d, cls))


@dataclasses.dataclass(frozen=True)
class VisualCLAConfig:
    """Composite config (reference: models/visualcla/configuration_visualcla.py:10-40)."""

    text_config: Any = dataclasses.field(default_factory=LlamaConfig)  # or a JambaConfig
    vision_config: ViTConfig = dataclasses.field(default_factory=ViTConfig)
    use_visual_resampler: bool = True
    visual_resampler_config: ResamplerConfig = dataclasses.field(
        default_factory=ResamplerConfig
    )
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12

    @property
    def num_image_tokens(self) -> int:
        """Number of image embeddings spliced into the LLM sequence.

        64 resampler queries by default; the reference's ``num_patch`` logic
        (models/visualcla/modeling_utils.py:136-139) falls back to full ViT length
        when num_query_tokens == -1.
        """
        n = self.visual_resampler_config.num_query_tokens
        if not self.use_visual_resampler or n == -1:
            return self.vision_config.seq_len
        return n

    @classmethod
    def from_hf_dict(cls, d: Mapping[str, Any]) -> "VisualCLAConfig":
        text = text_config_from_hf_dict(d.get("text_config") or {})
        vision = ViTConfig.from_hf_dict(d.get("vision_config") or {})
        res = ResamplerConfig.from_hf_dict(d.get("visual_resampler_config") or {})
        return cls(
            text_config=text,
            vision_config=vision,
            use_visual_resampler=d.get("use_visual_resampler", True),
            visual_resampler_config=res,
            initializer_range=d.get("initializer_range", 0.02),
            layer_norm_eps=d.get("layer_norm_eps", 1e-12),
        )

    @classmethod
    def from_pretrained(cls, path: str) -> "VisualCLAConfig":
        """Read a reference-format ``config.json`` from a checkpoint directory."""
        cfg_path = os.path.join(path, "config.json") if os.path.isdir(path) else path
        with open(cfg_path) as f:
            return cls.from_hf_dict(json.load(f))

    def to_hf_dict(self) -> dict:
        """The ``config.json`` schema (``from_hf_dict`` reads it back)."""
        return {**dataclasses.asdict(self), "model_type": "visualcla"}

    def save_pretrained(self, path: str) -> None:
        """Write ``config.json`` into the directory ``path``."""
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(self.to_hf_dict(), f, indent=2)


# LLaMA family dims, keyed like the reference merge script's emb_to_model_size
# (scripts/merge_llama_with_visualcla_lora.py:30-35: 4096->7B ... 8192->65B)
LLAMA_SIZES = {
    "7B": dict(hidden_size=4096, intermediate_size=11008,
               num_hidden_layers=32, num_attention_heads=32),
    "13B": dict(hidden_size=5120, intermediate_size=13824,
                num_hidden_layers=40, num_attention_heads=40),
    "33B": dict(hidden_size=6656, intermediate_size=17920,
                num_hidden_layers=60, num_attention_heads=52),
    "65B": dict(hidden_size=8192, intermediate_size=22016,
                num_hidden_layers=80, num_attention_heads=64),
}
EMB_TO_MODEL_SIZE = {4096: "7B", 5120: "13B", 6656: "33B", 8192: "65B"}


def llama_config_for_size(size: str, vocab_size: int = 49958) -> LlamaConfig:
    """LlamaConfig for a named family size ('7B'...'65B')."""
    return LlamaConfig(vocab_size=vocab_size, **LLAMA_SIZES[size])


def visualcla_config_for_size(size: str = "7B",
                              vocab_size: int = 49958) -> VisualCLAConfig:
    """Composite config for a VisualCLA variant at any LLaMA family size
    (vision tower and 6L/64q resampler as shipped)."""
    return VisualCLAConfig(
        text_config=llama_config_for_size(size, vocab_size),
        vision_config=ViTConfig(),
        visual_resampler_config=ResamplerConfig(
            hidden_size=1024, num_hidden_layers=6, num_attention_heads=16,
            intermediate_size=4096, num_query_tokens=64,
            add_pooling_layer=False,
        ),
    )


def tiny_visualcla_config(
    vocab_size: int = 128,
    hidden_size: int = 16,
    num_query_tokens: int = 4,
) -> VisualCLAConfig:
    """A small fixture config for tests (SURVEY.md §4: tiny 2-layer towers)."""
    return VisualCLAConfig(
        text_config=LlamaConfig(
            vocab_size=vocab_size,
            hidden_size=hidden_size,
            intermediate_size=hidden_size * 2,
            num_hidden_layers=2,
            num_attention_heads=4,
            max_position_embeddings=256,
        ),
        vision_config=ViTConfig(
            hidden_size=8,
            intermediate_size=16,
            num_hidden_layers=2,
            num_attention_heads=2,
            image_size=28,
            patch_size=14,
        ),
        visual_resampler_config=ResamplerConfig(
            hidden_size=8,
            num_hidden_layers=2,
            num_attention_heads=2,
            intermediate_size=16,
            num_query_tokens=num_query_tokens,
        ),
    )
