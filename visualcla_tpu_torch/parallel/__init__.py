"""Serving over a device mesh on ``torch.distributed`` (port of
visualcla_tpu/parallel/, its serving half): the partition rules
(``sharding``), the process group (``distributed``), the collectives and
the tensor-parallel layers (``tp``) and ring attention (``ring``).  The
pipeline schedule (``parallel/pipeline.py``) and FSDP at runtime belong to
training over a mesh, ROADMAP item 17."""
from .sharding import (  # noqa: F401
    DATA,
    MODEL,
    batch_spec,
    kv_cache_specs,
    make_mesh,
    param_specs,
    shard_params,
)
