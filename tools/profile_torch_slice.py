"""Where the PyTorch port's chat slice spends its time on one NVIDIA GPU.

    python3 tools/profile_torch_slice.py [--out profile.json] [--bits 4|8] [--kv_quant int8]
    python3 tools/profile_torch_slice.py --train 2|1 [--out train_profile.json]
    python3 tools/profile_torch_slice.py --train 2 --mesh none,tp,fsdp,pipeline

VisualCLA-7B at full width on seeded random bf16 weights (as chip_smoke.py
builds it), its text tower quantized on the card with ``--bits``, its KV
cache int8 with ``--kv_quant int8``.  Measures, for the B=1 chat prompt: the TTFT parts (host
preprocess, image encode, Engine.start), the decode rate with the CUDA
kernels and with their plain PyTorch versions swapped in, and a
torch.profiler breakdown of 10 decode steps (wall vs device time, device
time by kind of kernel, the largest kernels).  ``--train 2`` profiles
``chip_smoke.py`` phase 11's full-width training step instead (2: the
QLoRA step, 1: stage 1; B=1, S=512, remat): the step's forward, backward
and optimizer by CUDA events, ``Int8Linear``'s weight copies and the fp32
attention timed alone at the step's shapes, and a torch.profiler breakdown
of one step (device time by kind of kernel, the idle share, the largest
kernels).  ``--mesh`` profiles that step over each listed mesh at world
size 1 over NCCL (``chip_smoke.py`` phase 14: ``tp`` a (data 1, model 1)
mesh, ``fsdp`` the same with FSDP, ``pipeline`` a (pipe 1, data 1) pipeline
at n_micro 2 and B=2; ``none`` the unmeshed step, B=2 beside ``pipeline``):
the step's device ms, its profile and the host operators that take the most
self time.  Prints one JSON object (and writes it to ``--out``).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402

from visualcla_tpu_torch.core.config import visualcla_config_for_size  # noqa: E402
from visualcla_tpu_torch.processor import ImageProcessor  # noqa: E402
from visualcla_tpu_torch.text.prompt import encoding_text, img_marker_positions  # noqa: E402
from visualcla_tpu_torch import api  # noqa: E402
from visualcla_tpu_torch.engine.sampling import SamplingConfig  # noqa: E402
from visualcla_tpu_torch.fixtures import (PROMPT, SEED, make_tokenizer,  # noqa: E402
                                          plain_kernels, random_image)
from visualcla_tpu_torch.models import visualcla as vmod  # noqa: E402


def kernel_kind(name: str) -> str:
    """The kind of a device kernel, by its name."""
    # B1's two launches (splits, then the combine) and both B2 / B2u kernels
    if "flash_decode_" in name or "flash_attention_" in name:
        return "flash_attention"
    if "int4_" in name:
        return "int4_matmul"
    if any(k in name for k in ("nvjet", "gemm", "gemv", "splitKreduce", "cutlass")):
        return "gemm"
    if "copy_kernel" in name:
        return "copy"
    if "softmax" in name.lower():
        return "softmax"
    return "other"


def _profile_kernels(fn, n: int = 1) -> dict:
    """torch.profiler over ``n`` calls of ``fn``: wall and device ms a call,
    device ms by kind of kernel, the largest kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue  # device-side kernel rows only: no double counting
        kernels.append((e.self_device_time_total / n / 1e3, e.count // n, e.key[:100]))
    kernels.sort(reverse=True)
    by_kind = {}
    for ms, _, name in kernels:
        by_kind[kernel_kind(name)] = by_kind.get(kernel_kind(name), 0.0) + ms
    device = sum(k[0] for k in kernels)
    return {"wall_ms": wall / n * 1e3, "device_ms": device,
            "kernel_launches": sum(k[1] for k in kernels),
            "idle_share": 1 - device / (wall / n * 1e3), "device_ms_by_kind": by_kind,
            "top_kernels_ms": [list(k) for k in kernels[:15]]}


def _events_ms(fn, n: int = 3) -> float:
    """Median device ms of ``fn()`` between two CUDA events."""
    times = []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _host_ops(fn, top: int = 12) -> list:
    """torch.profiler over one call of ``fn``: the host operators with the
    most self CPU time, [ms, calls, name]."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.self_cpu_time_total / 1e3, e.count, e.key[:80]) for e in prof.key_averages()]
    return [list(r) for r in sorted(rows, reverse=True)[:top]]


def profile_mesh_train(kinds) -> dict:
    """The QLoRA step of ``chip_smoke.py`` phase 14 (b) / (c) over each mesh
    in ``kinds`` at world size 1."""
    import tempfile

    import numpy as np

    from visualcla_tpu_torch.fixtures import train_batch, train_model
    from visualcla_tpu_torch.parallel import distributed
    from visualcla_tpu_torch.parallel import pipeline as pp
    from visualcla_tpu_torch.parallel import tp
    from visualcla_tpu_torch.parallel.sharding import make_mesh, shard_params
    from visualcla_tpu_torch.train.lora import lora_trainable
    from visualcla_tpu_torch.train.trainer import (init_train_state, make_optimizer,
                                                   make_train_step_subset, partition_params)

    distributed.initialize("cuda", init_method=f"file://{tempfile.mkdtemp()}/store",
                           world_size=1, rank=0)
    cfg = visualcla_config_for_size("7B")
    tok = make_tokenizer(cfg.text_config.vocab_size)
    b1 = train_batch(cfg, tok)
    b2 = {k: np.concatenate([v, train_batch(cfg, tok, seed=SEED + 1)[k]]) for k, v in b1.items()}
    res = {"device": torch.cuda.get_device_name(0)}
    for kind in kinds:
        model = train_model(cfg, 2)
        pipe = None
        if kind in ("tp", "fsdp"):
            shard_params(model, make_mesh(1, 1), fsdp=kind == "fsdp")
        elif kind == "pipeline":
            pipe = pp.make_pipe_mesh(1, 1)
            pp.shard_text_params(model, pipe)
        opt = make_optimizer(learning_rate=1e-4, schedule="const")
        train, frozen = partition_params(model, lora_trainable)
        state = init_train_state(train, opt)
        step = make_train_step_subset(model, cfg, opt, lora_trainable, remat=True,
                                      pipeline_mesh=pipe, n_micro=2)
        for batch, label in ((b1, kind), (b2, kind + " B=2")):
            if (kind == "pipeline") != (batch is b2) and kind != "none":
                continue
            for _ in range(2):  # warm-up
                state, _ = step(state, frozen, batch)
            calls = dict(tp.CALLS)
            ms = _events_ms(lambda: step(state, frozen, batch))
            prof = _profile_kernels(lambda: step(state, frozen, batch))
            res[label] = {"step_ms": ms, "wall_ms": prof["wall_ms"],
                          "device_busy_ms": prof["device_ms"], "idle_share": prof["idle_share"],
                          "collectives_a_step": {k: (tp.CALLS[k] - calls[k]) // 4
                                                 for k in calls},
                          "device_ms_by_kind": prof["device_ms_by_kind"],
                          "host_ops_ms": _host_ops(lambda: step(state, frozen, batch))}
        del model, state, frozen, train
        torch.cuda.empty_cache()
    return res


def profile_train(stage: int) -> dict:
    """The training step of ``chip_smoke.py`` phase 11 at full width."""
    from visualcla_tpu_torch.fixtures import (TRAIN_SEQ, train_batch, train_model,
                                              train_step_flops)
    from visualcla_tpu_torch.models.llama import chunk_causal_attention
    from visualcla_tpu_torch.ops.linear import Int8Linear
    from visualcla_tpu_torch.train.lora import lora_trainable
    from visualcla_tpu_torch.train.trainer import (init_train_state, loss_fn, make_optimizer,
                                                   make_train_step_subset, partition_params,
                                                   stage1_trainable)

    cfg = visualcla_config_for_size("7B")
    tok = make_tokenizer(cfg.text_config.vocab_size)
    model = train_model(cfg, stage)
    batch = train_batch(cfg, tok)
    trainable = lora_trainable if stage == 2 else stage1_trainable
    opt = make_optimizer(learning_rate=1e-4, schedule="const")
    train, frozen = partition_params(model, trainable)
    state = init_train_state(train, opt)
    step = make_train_step_subset(model, cfg, opt, trainable, remat=True)
    for _ in range(2):  # warm-up
        state, _ = step(state, frozen, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = {"device": torch.cuda.get_device_name(0), "stage": stage, "seq": TRAIN_SEQ,
           "step_ms": _events_ms(lambda: step(state, frozen, batch)),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "tflop_a_step": train_step_flops(cfg, stage)["total"] / 1e12}
    res["mfu"] = res["tflop_a_step"] / res["step_ms"] / 989e-3

    parts = {"forward_ms": [], "backward_ms": [], "optimizer_ms": []}
    for _ in range(3):  # the step's three parts, as train_step runs them
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        for p in train.values():
            p.grad = None
        ev[0].record()
        loss = loss_fn(model, cfg, batch, remat=True)
        ev[1].record()
        loss.backward()
        ev[2].record()
        opt.update_(train, {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                            for n, p in train.items()}, state.opt_state)
        ev[3].record()
        torch.cuda.synchronize()
        for k, i in zip(parts, range(3)):
            parts[k].append(ev[i].elapsed_time(ev[i + 1]))
    res.update({k: statistics.median(v) for k, v in parts.items()})

    # Int8Linear's bf16 copies of its weight: the forward's and the remat
    # recompute's (autograd keeps the latter for the input gradient)
    int8 = [m for m in model.modules() if isinstance(m, Int8Linear)]
    res["int8_copy_ms_a_step"] = 2 * _events_ms(
        lambda: [m.q.to(torch.bfloat16) for m in int8]) if int8 else 0.0
    # the decoder's fp32 attention: forward twice (remat) and backward, 32 layers
    t = cfg.text_config
    q = torch.randn(1, TRAIN_SEQ, t.num_attention_heads, t.head_dim, device="cuda",
                    dtype=torch.bfloat16, requires_grad=True)
    k = torch.randn(1, t.num_key_value_heads, TRAIN_SEQ, t.head_dim, device="cuda",
                    dtype=torch.bfloat16, requires_grad=True)
    valid = torch.ones(1, TRAIN_SEQ, dtype=torch.bool, device="cuda")

    def attention():
        chunk_causal_attention(q, k, k, valid).sum().backward()
        with torch.no_grad():
            chunk_causal_attention(q, k, k, valid)

    res["attention_ms_a_step"] = t.num_hidden_layers * _events_ms(attention)
    res["profile"] = _profile_kernels(lambda: step(state, frozen, batch))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=None)
    ap.add_argument("--new_tokens", type=int, default=64)
    ap.add_argument("--bits", type=int, choices=(4, 8), default=None,
                    help="quantize the text tower to int4 or int8")
    ap.add_argument("--kv_quant", choices=("none", "int8"), default="none")
    ap.add_argument("--train", type=int, choices=(1, 2), default=None,
                    help="profile the full-width training step of this stage instead")
    ap.add_argument("--mesh", default=None,
                    help="with --train 2: comma-separated meshes among none, tp, fsdp, "
                         "pipeline (world size 1)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_slice: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.train and args.mesh:
        return _emit(profile_mesh_train(args.mesh.split(",")), args.out)
    if args.train:
        return _emit(profile_train(args.train), args.out)

    cfg = visualcla_config_for_size("7B")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = vmod.init_random_(
        vmod.VisualCLAModel(cfg, device="cuda", dtype=torch.bfloat16), gen)
    if args.bits:
        vmod.quantize_text_tower_(model, args.bits)
    tok = make_tokenizer(cfg.text_config.vocab_size)
    bundle = api.VisualCLA(model, cfg, tok, ImageProcessor(image_size=224),
                           kv_quant=args.kv_quant)
    eng = bundle.engine
    image = random_image(SEED)
    ids = encoding_text([], PROMPT, bundle.num_patch, tok)["input_ids"]
    pos = img_marker_positions(ids, tok.img_start_token_id)
    greedy = SamplingConfig.greedy(max_new_tokens=args.new_tokens)
    res = {"device": torch.cuda.get_device_name(0), "bits": args.bits or 16,
           "kv_quant": args.kv_quant, "prompt_tokens": int(ids.shape[1]),
           "bucket": eng.bucket_len(ids.shape[1])}
    sync = torch.cuda.synchronize

    for _ in range(2):  # warm-up
        api.chat(bundle, image, PROMPT, [], SamplingConfig.greedy(4), verbose=False)
    parts = {"preprocess_ms": [], "encode_image_ms": [], "start_ms": []}
    for _ in range(5):
        sync()
        t0 = time.perf_counter()
        pv = bundle.image_processor(image)["pixel_values"]
        t1 = time.perf_counter()
        with torch.no_grad():
            vmod.encode_image(model, cfg, torch.as_tensor(pv).to("cuda", torch.bfloat16))
        sync()
        t2 = time.perf_counter()
        st = eng.start(ids, pv, pos, greedy)  # encode + splice + prefill + first token
        int(st.last_token[0])
        t3 = time.perf_counter()
        eng.release(st.ws)
        for k, v in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
            parts[k].append(v * 1e3)
    res.update({k: statistics.median(v) for k, v in parts.items()})

    pv = bundle.image_processor(image)["pixel_values"]

    def decode_rate():  # the decode loop (captured; eager under plain_kernels)
        st = eng.start(ids, pv, pos, greedy)
        sync()
        t0 = time.perf_counter()
        steps = eng.decode(st, greedy) - 1
        sync()
        eng.release(st.ws)
        return steps / (time.perf_counter() - t0)

    def start_ms():
        sync()
        t0 = time.perf_counter()
        st = eng.start(ids, pv, pos, greedy)
        int(st.last_token[0])
        ms = (time.perf_counter() - t0) * 1e3
        eng.release(st.ws)
        return ms

    # kernels, plain versions, kernels: compared within this one run
    for label, attn in (("kernels", contextlib.nullcontext), ("plain", plain_kernels),
                        ("kernels_again", contextlib.nullcontext)):
        with attn():
            res[f"decode_tok_s_{label}"] = statistics.median(decode_rate() for _ in range(3))
            res[f"start_ms_{label}"] = statistics.median(start_ms() for _ in range(3))

    st = eng.start(ids, pv, pos, greedy)
    for _ in range(3):
        st = eng.step(st, greedy)
    holder = [st]

    def one_step():
        holder[0] = eng.step(holder[0], greedy)

    prof = _profile_kernels(one_step, n=10)
    res["profiled_step_wall_ms"] = prof["wall_ms"]
    res["profiled_step_device_ms"] = prof["device_ms"]
    res["device_ms_per_step_by_kind"] = prof["device_ms_by_kind"]
    res["top_kernels_ms_per_step"] = prof["top_kernels_ms"]
    return _emit(res, args.out)


def _emit(res: dict, out) -> int:
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
