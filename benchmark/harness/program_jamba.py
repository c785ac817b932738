"""The program under test for a Jamba configuration: the port's model over a
Jamba text tower, built from the whole configuration file (its top-level
keys are the tower's published ``config.json``, which ``run.py``'s
``text_config`` keeps only the LLaMA keys of), loaded through the port's
own loader from ``harness/weights_jamba``'s tensors, each quantized on the
card as it arrives, behind ``apps/serve.PoolWorker(paged=True)`` as
``harness/program.build_worker`` builds it."""
from __future__ import annotations

import torch

from . import program

# the keys of HF's JambaConfig that the port reads (the rest of the file is
# the benchmark's own)
TEXT_KEYS = ("model_type", "vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
             "num_attention_heads", "num_key_value_heads", "max_position_embeddings",
             "rms_norm_eps", "tie_word_embeddings", "hidden_act", "attn_layer_period",
             "attn_layer_offset", "expert_layer_period", "expert_layer_offset", "num_experts",
             "num_experts_per_tok", "mamba_d_state", "mamba_d_conv", "mamba_expand",
             "mamba_dt_rank", "mamba_conv_bias", "mamba_proj_bias", "sliding_window")


def has_jamba() -> bool:
    """Whether the port serves a Jamba tower at all."""
    import importlib.util

    return importlib.util.find_spec("visualcla_tpu_torch.models.jamba") is not None


def prebuild(log) -> None:
    """Build (or find built) the kernels the Jamba tower adds: B7 and B8."""
    import time

    from visualcla_tpu_torch.ops.cuda import build

    t = time.perf_counter()
    build.build(["moe_int4", "selective_scan"])
    log(f"B7 and B8 built or found in {time.perf_counter() - t:.3f} s")


def text_config(cfg: dict) -> dict:
    return {k: cfg[k] for k in TEXT_KEYS if k in cfg}


def port_config(cfg: dict):
    from visualcla_tpu_torch.core.config import VisualCLAConfig

    return VisualCLAConfig.from_hf_dict({
        "text_config": text_config(cfg), "vision_config": cfg["vision_config"],
        "visual_resampler_config": cfg["visual_resampler_config"],
        "use_visual_resampler": True})


def build_model(cfg: dict, weights: dict, device, dtype=None):
    """-> (the port's VisualCLAModel over its Jamba tower, its config).
    ``weights`` (tower -> {name: tensor}; the text tower drawn on access) is
    consumed.  The model is bf16 on the card; on the CPU (the benchmark's
    own tests, at a tiny size) float32, so that the comparison there sees
    the served path's state handling rather than bf16 rounding."""
    from visualcla_tpu_torch.checkpoint.convert import load_state_dicts

    if dtype is None:
        dtype = torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32
    if cfg["weights"] not in ("int4", "bf16"):
        raise ValueError(f"weights tier {cfg['weights']!r}: the harness knows bf16 and int4")
    prefixes = {"text": "", "vision": "vision_model.", "resampler": "visual_resampler.",
                "projection": "image_projection_layer."}
    sds = {tower: (weights[tower], prefixes[tower]) for tower in prefixes}
    model, pcfg = load_state_dicts(sds, port_config(cfg), device=device, dtype=dtype,
                                   quantize="int4" if cfg["weights"] == "int4" else "none")
    weights.clear()
    return model, pcfg


build_worker = program.build_worker
