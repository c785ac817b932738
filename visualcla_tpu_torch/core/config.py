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


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Decoder config (schema-compatible with HF LlamaConfig JSON)."""

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

    @classmethod
    def from_hf_dict(cls, d: Mapping[str, Any]) -> "LlamaConfig":
        return cls(**_take(d, cls))


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

    text_config: LlamaConfig = dataclasses.field(default_factory=LlamaConfig)
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
        text = LlamaConfig.from_hf_dict(d.get("text_config") or {})
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
