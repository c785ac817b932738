"""Where the PyTorch port's chat slice spends its time on one NVIDIA GPU.

    python3 tools/profile_torch_slice.py [--out profile.json] [--bits 4|8] [--kv_quant int8]

VisualCLA-7B at full width on seeded random bf16 weights (as chip_smoke.py
builds it), its text tower quantized on the card with ``--bits``, its KV
cache int8 with ``--kv_quant int8``.  Measures, for the B=1 chat prompt: the TTFT parts (host
preprocess, image encode, Engine.start), the decode rate with the CUDA
kernels and with their plain PyTorch versions swapped in, and a
torch.profiler breakdown of 10 decode steps (wall vs device time, device
time by kind of kernel, the largest kernels).  Prints one JSON object (and
writes it to ``--out``).
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
    return "other"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=None)
    ap.add_argument("--new_tokens", type=int, default=64)
    ap.add_argument("--bits", type=int, choices=(4, 8), default=None,
                    help="quantize the text tower to int4 or int8")
    ap.add_argument("--kv_quant", choices=("none", "int8"), default="none")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_slice: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

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

    from torch.profiler import ProfilerActivity, profile

    st = eng.start(ids, pv, pos, greedy)
    for _ in range(3):
        st = eng.step(st, greedy)
    sync()
    n = 10
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            st = eng.step(st, greedy)
        sync()
        wall = time.perf_counter() - t0
    kernels = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue  # device-side kernel rows only: no double counting
        kernels.append((e.self_device_time_total / n / 1e3, e.count // n, e.key[:100]))
    kernels.sort(reverse=True)
    res["profiled_step_wall_ms"] = wall / n * 1e3
    res["profiled_step_device_ms"] = sum(k[0] for k in kernels)
    by_kind = {}
    for ms, _, name in kernels:
        by_kind[kernel_kind(name)] = by_kind.get(kernel_kind(name), 0.0) + ms
    res["device_ms_per_step_by_kind"] = by_kind
    res["top_kernels_ms_per_step"] = [list(k) for k in kernels[:15]]
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
