"""The program under test, built from a configuration file and the
benchmark's weights: the port's model, loaded through its own loader of
published checkpoints and quantized on the device by its own code, behind
``apps/serve.PoolWorker`` as ``apps/serve.py --pool N --paged`` builds it.
Everything of the port that the harness touches is imported here."""
from __future__ import annotations

import torch


def prebuild(log) -> None:
    """Build (or find built) the port's CUDA kernels, all at once, in its own
    build directory inside the checkout."""
    import time

    from visualcla_tpu_torch.ops.cuda import build

    t = time.perf_counter()
    build.build(["flash_attention", "int4_matmul", "paged_attention"])
    log(f"kernels built or found in {time.perf_counter() - t:.3f} s {build.build_seconds}")


def port_config(cfg: dict):
    from visualcla_tpu_torch.core.config import VisualCLAConfig

    return VisualCLAConfig.from_hf_dict({
        "text_config": cfg["text_config"], "vision_config": cfg["vision_config"],
        "visual_resampler_config": cfg["visual_resampler_config"],
        "use_visual_resampler": True})


def build_model(cfg: dict, weights: dict, device, dtype=torch.bfloat16):
    """-> (the port's VisualCLAModel, its config).  ``weights`` (tower ->
    {name: tensor}) is consumed."""
    from visualcla_tpu_torch.checkpoint.convert import load_state_dicts
    from visualcla_tpu_torch.models.visualcla import quantize_text_tower_

    prefixes = {"text": "", "vision": "vision_model.", "resampler": "visual_resampler.",
                "projection": "image_projection_layer."}
    sds = {tower: (weights[tower], prefixes[tower]) for tower in prefixes}
    model, pcfg = load_state_dicts(sds, port_config(cfg), device=device, dtype=dtype)
    weights.clear()
    if cfg["weights"] == "int4":
        quantize_text_tower_(model, 4)
    elif cfg["weights"] != "bf16":
        raise ValueError(f"weights tier {cfg['weights']!r}: the harness knows bf16 and int4")
    return model, pcfg


def build_worker(cfg: dict, model, pcfg, tokenizer, seed: int):
    """The served stack: ``VisualCLA`` bundle -> ``PoolWorker(paged=True)``
    (its ``Scheduler`` thread starts here)."""
    from visualcla_tpu_torch.api import VisualCLA
    from visualcla_tpu_torch.apps.serve import PoolWorker
    from visualcla_tpu_torch.processor import ImageProcessor

    pool = cfg["pool"]
    size = cfg["vision_config"]["image_size"]
    bundle = VisualCLA(model, pcfg, tokenizer, ImageProcessor(image_size=size),
                       max_seq_len=pool["max_seq_len"])
    worker = PoolWorker(bundle, pool_size=pool["rows"], paged=True,
                        block_size=pool["block_size"], num_blocks=pool["num_blocks"],
                        kv_quant="int8" if cfg["kv_cache"] == "int8" else "none",
                        seed=seed % (2 ** 63))
    sched = worker.scheduler
    sched.step_chunk = pool["step_chunk"]
    sched.prefill_chunk = pool["prefill_chunk"]
    return bundle, worker
