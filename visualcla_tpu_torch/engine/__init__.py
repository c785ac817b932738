"""Engines of the port (port of visualcla_tpu/engine/): prefill and decode
(``generate``), the samplers (``sampling``), the contiguous pool and its
``Scheduler`` (``server``), the paged pool (``paged``), speculative decoding
and beams; the names the JAX package's ``engine`` exports."""
from .generate import DecodeState, Engine  # noqa: F401
from .sampling import SamplingConfig, default_sampling_config, sample_step  # noqa: F401
from .server import Request, Scheduler, ServingEngine, generate_sync  # noqa: F401
