"""Serving and training over a device mesh on ``torch.distributed`` (port of
visualcla_tpu/parallel/): the partition rules (``sharding``), the process
group (``distributed``), the collectives and the tensor-parallel layers
(``tp``), ring attention (``ring``), FSDP at runtime (``fsdp``) and the
GPipe schedule of the decoder stack (``pipeline``)."""
from .pipeline import (  # noqa: F401
    PIPE,
    make_pipe_mesh,
    make_pipe_tp_mesh,
    pipeline_forward,
    pipeline_kv_cache,
    shard_text_params,
    stage_param_specs,
)
from .sharding import (  # noqa: F401
    DATA,
    MODEL,
    batch_spec,
    kv_cache_specs,
    make_mesh,
    param_specs,
    shard_params,
)
