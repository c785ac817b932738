"""Plain float32 reference of a Jamba text tower for the tests: the
benchmark's reference (``benchmark/reference/jamba.py``, transformers'
``modeling_jamba`` 4.57 with ``use_mamba_kernels=False``: the Mamba mixer of
``JambaMambaMixer.slow_forward`` with its sequential scan, ``JambaAttention``
without positions, ``JambaSparseMoeBlock`` with the router's softmax in f32
and top-k weights not renormalized, the decoder layers) read over HF-named
tensors given in a mapping, one sequence at a time, with no kernel, cache or
batching, importing nothing of the port.  Its departures from HF's code are
listed there: the routing weights and ``C . s`` stay f32, and each token's
experts are summed in its top-k order."""
from __future__ import annotations

from typing import Mapping, Optional

import torch

from benchmark.harness.weights_jamba import dt_rank, layer_kinds  # noqa: F401
from benchmark.reference.jamba import text_logits


def logits(ids: torch.Tensor, cfg: Mapping, weights: Mapping[str, torch.Tensor],
           embeds: Optional[torch.Tensor] = None, state_dtype=None) -> torch.Tensor:
    """(S,) ids (or (S, H) embeddings) -> (S, V) float32 logits;
    ``state_dtype`` torch.bfloat16 rounds the SSM state after every token."""
    return text_logits(ids, cfg, weights, embeds, state_dtype)
