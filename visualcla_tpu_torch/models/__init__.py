"""The model towers (port of visualcla_tpu/models/)."""
from . import clip_vit, llama, resampler, visualcla  # noqa: F401
