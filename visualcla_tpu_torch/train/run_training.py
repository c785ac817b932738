"""Training CLI (port of visualcla_tpu/train/run_training.py): the reference's
two-stage recipe on one device.

Stage 1 (pretrain):  resampler + projection (+ vision) on image-caption pairs.
Stage 2 (SFT):       + text/vision LoRA + embed/lm_head on instruction data.

Usage:
  python -m visualcla_tpu_torch.train.run_training \\
      --checkpoint NATIVE_CKPT --data data.jsonl --image_dir IMGS \\
      --stage 2 --lora_r 8 --lora_alpha 16 --batch_size 8 --steps 1000 \\
      --learning_rate 1e-4 --output OUT [--remat] [--save_every N] [--resume DIR]
      [--device cpu]

The checkpoint loads in fp32 on the card (``--device cpu`` for the CPU).  The
step is ``make_train_step_subset``: gradients and Adam state exist for the
trainable leaves only (the CLI has no weight decay, so this equals the JAX
CLI's masked full-tree step).  ``--save_every`` writes train states to
OUT/train_state/step_N; ``--resume`` (such a dir, or a root holding them)
restores one and continues from its step: the batches it had consumed are
skipped, so the run goes on as if it had not stopped.  Outputs: the native
checkpoint (LoRA merged, bf16) at --output with the checkpoint's tokenizer
and preprocessor files, and the adapter in PEFT format at --output/adapter.

Over several devices, one process each (``torchrun --nproc_per_node N -m
visualcla_tpu_torch.train.run_training ... --n_data D``), with the JAX CLI's
rules: ``--pipeline P`` (> 1) builds a (pipe P, data max(n_data, 1)) mesh
and no (data, model) mesh, GPipe over ``--n_micro`` microbatches (default
2); else ``--n_data D`` (> 0) builds a (data D, model N / D) mesh, and
``--fsdp`` also shards every layer stack over ``data``; one device gets no
mesh (``--fsdp`` has no effect there).  Every rank reads the same global
batch from the seeded loader and takes its rows; rank 0 alone writes the
train states, the adapter, the checkpoint and the logs, each the same as a
one-device run's.
"""
from __future__ import annotations

import argparse
import logging
import os
import shutil
import time

logger = logging.getLogger(__name__)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--checkpoint", required=True, help="native checkpoint dir")
    ap.add_argument("--data", required=True, help="json/jsonl records")
    ap.add_argument("--image_dir", default="")
    ap.add_argument("--output", required=True)
    ap.add_argument("--stage", type=int, choices=(1, 2), default=2)
    ap.add_argument("--lora_r", type=int, default=8)
    ap.add_argument("--lora_alpha", type=float, default=16.0)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--learning_rate", type=float, default=1e-4)
    ap.add_argument("--warmup_steps", type=int, default=100)
    ap.add_argument("--grad_clip", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n_data", type=int, default=0,
                    help="data-parallel axis size; 0 = no mesh; the rest of the devices "
                         "go to the TP axis")
    ap.add_argument("--log_every", type=int, default=10)
    ap.add_argument("--save_every", type=int, default=0,
                    help="save the train state every N steps (0 = off)")
    ap.add_argument("--resume", default=None,
                    help="resume from a train-state dir (or a root containing step_N dirs)")
    ap.add_argument("--remat", action="store_true",
                    help="recompute each layer in the backward (memory for FLOPs)")
    ap.add_argument("--pipeline", type=int, default=0,
                    help="pipeline-parallel stages for the text tower (GPipe over a 'pipe' "
                         "axis; 0 = off; layers must divide evenly; combines with --n_data "
                         "as DP)")
    ap.add_argument("--n_micro", type=int, default=2,
                    help="GPipe microbatches per step (with --pipeline)")
    ap.add_argument("--fsdp", action="store_true",
                    help="layer-axis parameter sharding over the data axis (needs "
                         "num_layers %% n_data == 0)")
    ap.add_argument("--device", default=None, help="default: the GPU; 'cpu' to run there")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    import torch

    from ..api import _default_device
    from ..checkpoint.convert import SIDE_FILES
    from ..checkpoint.from_jax import params_to_jax
    from ..checkpoint.serialize import load_checkpoint, save_checkpoint
    from ..parallel import distributed
    from ..processor import ImageProcessor
    from ..text import VisualCLATokenizer
    from .checkpointing import latest_step_dir, restore_train_state, save_train_state
    from .data import DataLoader, ExampleBuilder, load_records
    from .lora import add_lora, export_adapter, lora_trainable, merge_lora
    from .trainer import (init_train_state, make_optimizer, make_train_step_subset,
                          partition_params, stage1_trainable)

    device = torch.device(args.device) if args.device else _default_device()
    mesh = pipe_mesh = None
    if args.pipeline > 1:  # layers % stages, as JAX checks, before any process group
        from ..core.config import VisualCLAConfig
        from ..parallel.pipeline import stage_param_specs

        stage_param_specs(args.pipeline, VisualCLAConfig.from_pretrained(args.checkpoint)
                          .text_config)
    if args.pipeline > 1 or (args.n_data > 0 and distributed.world() > 1):
        distributed.initialize(device.type)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        if args.pipeline <= 1:
            from ..parallel.sharding import make_mesh

            mesh = make_mesh(args.n_data)
    elif distributed.world() > 1:
        raise ValueError(f"{distributed.world()} processes and no mesh: pass --n_data or --pipeline")
    lead = distributed.rank() == 0

    # the pipeline shards the text tower itself, after the whole model loads
    model, cfg = load_checkpoint(args.checkpoint, device=device, dtype=torch.float32, mesh=mesh)
    if args.pipeline > 1:
        from ..parallel.pipeline import make_pipe_mesh

        pipe_mesh = make_pipe_mesh(args.pipeline, max(args.n_data, 1))
    tokenizer = VisualCLATokenizer.from_pretrained(args.checkpoint)
    if os.path.exists(os.path.join(args.checkpoint, "preprocessor_config.json")):
        ip = ImageProcessor.from_pretrained(args.checkpoint)
    else:
        size = cfg.vision_config.image_size
        ip = ImageProcessor(image_size=size, crop_size=size)

    if args.stage == 2:
        add_lora(model, r=args.lora_r, alpha=args.lora_alpha,
                 generator=torch.Generator(device=device).manual_seed(args.seed))
        trainable = lora_trainable
    else:
        trainable = stage1_trainable
    if pipe_mesh is not None:
        from ..parallel.pipeline import shard_text_params

        shard_text_params(model, pipe_mesh)
    if mesh is not None and args.fsdp:
        from ..parallel.fsdp import shard_layers

        shard_layers(model, mesh)

    records = load_records(args.data)
    builder = ExampleBuilder(
        tokenizer, ip, num_patch=cfg.num_image_tokens,
        image_dir=args.image_dir, max_len=cfg.text_config.max_position_embeddings,
    )
    total = min(args.steps, args.epochs * max(1, len(records) // args.batch_size))
    optimizer = make_optimizer(
        learning_rate=args.learning_rate, warmup_steps=args.warmup_steps,
        total_steps=total, grad_clip=args.grad_clip,
    )
    train, frozen = partition_params(model, trainable)
    step_fn = make_train_step_subset(model, cfg, optimizer, trainable, remat=args.remat,
                                     pipeline_mesh=pipe_mesh, n_micro=args.n_micro)
    state = init_train_state(train, optimizer)
    if args.resume:
        src = latest_step_dir(args.resume) or args.resume
        state = restore_train_state(src, state)
        logger.info("resumed train state from %s (step %d)", src, state.step)

    step = start = state.step
    seen = 0
    t0 = time.time()
    for epoch in range(args.epochs):
        if step >= args.steps:
            break
        loader = DataLoader(
            records, builder, batch_size=args.batch_size,
            image_size=cfg.vision_config.image_size,
            seed=args.seed + epoch, pad_id=tokenizer.pad_token_id,
        )
        for batch in loader:
            seen += 1
            if seen <= start:  # consumed before the saved state
                continue
            state, metrics = step_fn(state, frozen, batch)
            step = state.step
            if args.save_every and step % args.save_every == 0:
                save_train_state(os.path.join(args.output, "train_state", f"step_{step}"), state)
            if lead and step % args.log_every == 0:
                logger.info("step %d/%d loss %.4f gnorm %.3f (%.2f s/step)",
                            step, total, float(metrics["loss"]), float(metrics["grad_norm"]),
                            (time.time() - t0) / (step - start))
            if step >= args.steps:
                break

    if args.stage == 2:
        export_adapter(model, os.path.join(args.output, "adapter"),
                       r=args.lora_r, alpha=args.lora_alpha)
        merge_lora(model)
    flat = params_to_jax(model)  # over a mesh: the whole tensors, every rank taking part
    if lead:
        save_checkpoint(args.output, flat, cfg, dtype="bfloat16")
        for name in SIDE_FILES:
            src = os.path.join(args.checkpoint, name)
            if os.path.exists(src):
                shutil.copy(src, os.path.join(args.output, name))
        logger.info("saved trained checkpoint -> %s (step %d)", args.output, step)
    if mesh is not None or pipe_mesh is not None:
        import torch.distributed as dist

        dist.barrier()
    return state



if __name__ == "__main__":
    main()
