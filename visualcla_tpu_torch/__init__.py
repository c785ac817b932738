"""visualcla_tpu_torch — the PyTorch + CUDA port of visualcla_tpu.

The JAX package ``visualcla_tpu`` stays the reference; this package mirrors
its module names and public surface (``chat``, ``chat_in_stream``,
``get_model_and_tokenizer_and_processor``, ``VisualCLA``) on PyTorch, with the
Pallas kernels of the main path replaced by hand-written CUDA kernels
(``csrc/``).  Host-only code (configs, tokenizer, prompt protocol, image
preprocessing) is imported from ``visualcla_tpu``, whose package import pulls
in only its config module.  This package never imports jax.
"""

__version__ = "0.1.0"

from visualcla_tpu.core.config import (  # noqa: F401
    LlamaConfig,
    ResamplerConfig,
    ViTConfig,
    VisualCLAConfig,
)


def __getattr__(name):
    # the API (and torch's model code) loads on first use
    if name in ("chat", "chat_in_stream", "get_model_and_tokenizer_and_processor",
                "VisualCLA", "DEFAULT_GENERATION_CONFIG", "as_sampling_config"):
        from . import api

        return getattr(api, name)
    raise AttributeError(f"module 'visualcla_tpu_torch' has no attribute {name!r}")
