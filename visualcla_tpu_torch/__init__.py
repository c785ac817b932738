"""visualcla_tpu_torch — the PyTorch + CUDA port of visualcla_tpu.

The JAX package ``visualcla_tpu`` stays the reference; this package mirrors
its module names and public surface (``chat``, ``chat_in_stream``,
``get_model_and_tokenizer_and_processor``, ``VisualCLA``) on PyTorch, with the
Pallas kernels of the main path replaced by hand-written CUDA kernels
(``csrc/``).  Host-only code (configs, tokenizer, prompt protocol, image
preprocessing, and their C++ cores under ``csrc/host/``) is the package's own
copy of the JAX package's host modules, under the same names.  This package
imports neither jax nor anything of ``visualcla_tpu``.
"""

__version__ = "0.1.0"

from .core.config import (  # noqa: F401
    LlamaConfig,
    ResamplerConfig,
    ViTConfig,
    VisualCLAConfig,
)


def __getattr__(name):
    # the API (and torch's model code) loads on first use
    if name in ("chat", "chat_in_stream", "get_model_and_tokenizer_and_processor",
                "hijack_samplers", "VisualCLA", "DEFAULT_GENERATION_CONFIG",
                "load_generation_preset", "as_sampling_config"):
        from . import api

        return getattr(api, name)
    if name == "VisionPipeline":
        from .pipeline import VisionPipeline

        return VisionPipeline
    raise AttributeError(f"module 'visualcla_tpu_torch' has no attribute {name!r}")
