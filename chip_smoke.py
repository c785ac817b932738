"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one line of findings each:
  1. device  — the card's name and power limit (nvidia-smi), torch and CUDA
               versions; no CUDA device is an error, never a CPU run;
  2. build   — build the CUDA kernels from ``visualcla_tpu_torch/csrc``;
  3. kernels — each kernel against its plain PyTorch version on the card, in
               bf16 at the 7B head shapes (MHA and GQA) and at the main
               path's own shapes (32 layers, the chat prompt's bucket), with
               device times;
  4. slice   — VisualCLA-7B at full width on seeded random bf16 weights made
               on the card: prefill logits through the kernels against the
               plain attention versions (loosely in bf16, tightly on an fp32
               copy of the weights); greedy ``chat``, ``chat_in_stream``
               (same ids), the default sampled ``chat``; a B=2 ``generate``
               of uneven prompts whose rows equal their single-row runs (in
               fp32: bf16 GEMMs round by batch shape); the launch counters
               of the greedy chat alone; TTFT and B=1 decode tokens/s;
  5. the kernel summary as one JSON line, then the result line.
Exits non-zero if any phase fails.  Needs no network and no JAX.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from visualcla_tpu.core.config import visualcla_config_for_size
from visualcla_tpu.processor import ImageProcessor
from visualcla_tpu.text.prompt import encoding_text, img_marker_positions
from visualcla_tpu_torch import api
from visualcla_tpu_torch.engine.generate import PROMPT_BUCKETS, pick_bucket
from visualcla_tpu_torch.engine.sampling import SamplingConfig
from visualcla_tpu_torch.fixtures import (PROMPT, SEED, make_tokenizer, plain_attention,
                                          random_image)
from visualcla_tpu_torch.models.visualcla import VisualCLAModel, init_random_
from visualcla_tpu_torch.ops.cuda import build
from visualcla_tpu_torch.ops.cuda import flash_attention as fa

ATOL = RTOL = 2e-2  # bf16 output rounding plus another summation order
KERNEL_SOURCE = "visualcla_tpu_torch/csrc/flash_attention.cu"
REPLACES = {
    "flash_decode": "visualcla_tpu/ops/pallas/flash_attention.py:120",  # _decode_kernel
    "flash_prefill": "visualcla_tpu/ops/pallas/flash_attention.py:29",  # _flash_kernel
}


def device_ms(fn, calls: int = 10, replays: int = 5) -> float:
    """Device time of one call: ``fn(0) .. fn(calls - 1)`` captured in a CUDA
    graph, replayed and timed with events, so host launch overhead is
    excluded."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(i)
    graph.replay()
    times = []
    for _ in range(replays):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is "
                         "False); this script measures the GPU and never runs on the CPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi)
    print(f"[1 device] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    return {"smi": smi}


def phase_build() -> None:
    t0 = time.perf_counter()
    fa.build_kernels()
    print(f"[2 build] flash_attention.cu built and loaded in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {build.build_seconds.get('flash_attention', 0.0):.2f} s)",
          flush=True)


def _kernel_case(kind, B, Sq, N, Nkv, gen, L=2, S=2048, hd=128, slot0=272):
    """Inputs at the 7B head shapes: row 1 of a prefill is left padded; a
    decode batch has per-row slots from ``slot0``, ragged validity and, at
    B=8, one fully masked row."""
    dev = "cuda"

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    q = rnd(B, Sq, N, hd)
    kc, vc = rnd(L, B, Nkv, S, hd), rnd(L, B, Nkv, S, hd)
    if kind == "prefill":
        valid = torch.zeros(B, S, dtype=torch.bool, device=dev)
        valid[:, :Sq] = True
        if B > 1:
            valid[1, :Sq // 3] = False  # left padding
        slot = 0
    else:
        slot = torch.tensor([slot0 + 131 * b for b in range(B)], dtype=torch.int32, device=dev)
        valid = torch.arange(S, device=dev)[None, :] <= slot[:, None].long()
        for b in range(B):
            valid[b, :b + 3] = False  # ragged left padding
        if B == 8:
            valid[5] = False  # a fully masked row: the kernel emits zeros
    return q, kc, vc, valid, slot


def _wrapper_and_plain(kind):
    if kind == "prefill":
        return fa.flash_prefill_stacked, fa.flash_prefill_stacked_ref
    return fa.flash_decode_stacked, fa.flash_decode_stacked_ref


def _against_plain(kind, q, kc, vc, valid, slot, layer):
    """The kernel's output against its plain version, computed in fp32 from
    the same bf16 inputs: (max abs error, within tolerance and finite)."""
    wrapper, plain = _wrapper_and_plain(kind)
    out = wrapper(q, kc, vc, valid, slot, layer)
    torch.cuda.synchronize()
    ref = plain(q.float(), kc.float(), vc.float(), valid, slot, layer)
    err = (out.float() - ref).abs()
    ok = bool((err <= ATOL + RTOL * ref.abs()).all()) and bool(torch.isfinite(out).all())
    if kind == "decode" and q.shape[0] == 8:
        ok = ok and bool((out[5] == 0).all())  # the fully masked row
    return err.max().item(), ok


def phase_kernels(prompt_bucket: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = {"flash_decode": 0.0, "flash_prefill": 0.0}
    cases, failures = [], []
    for N, Nkv in ((32, 32), (32, 8)):
        for kind, shapes in (("prefill", [(B, Sq) for Sq in (256, 2048) for B in (1, 2)]),
                             ("decode", [(B, 1) for B in (1, 8)])):
            name = "flash_" + kind
            for B, Sq in shapes:
                q, kc, vc, valid, slot = _kernel_case(kind, B, Sq, N, Nkv, gen)
                wrapper, plain = _wrapper_and_plain(kind)
                err, ok = _against_plain(kind, q, kc, vc, valid, slot, 1)
                worst[name] = max(worst[name], err)
                ms = device_ms(lambda i: wrapper(q, kc, vc, valid, slot, 1))
                plain_ms = device_ms(lambda i: plain(q, kc, vc, valid, slot, 1), calls=2)
                cases.append(f"{kind}(N{N}/{Nkv},B{B},Sq{Sq}) err={err:.2e} "
                             f"{ms * 1e3:.1f}us/plain {plain_ms * 1e3:.1f}us")
                if not ok:
                    failures.append(cases[-1])
                del q, kc, vc
    # the main path's shapes: the B=1 chat prompt's bucket in the default
    # 2048-slot cache of all 32 layers; decode 16 tokens into the answer.
    # Checked at layer 7, then timed two ways: over all 32 layers in turn, as
    # a decode step reads them (each layer's K/V comes from HBM), and on
    # layer 7 alone (its K/V stays in the 50 MB L2 between calls)
    main, main_cases = {}, []
    for kind, B, Sq in (("prefill", 1, prompt_bucket), ("decode", 1, 1)):
        name = "flash_" + kind
        q, kc, vc, valid, slot = _kernel_case(kind, B, Sq, 32, 32, gen, L=32,
                                              slot0=prompt_bucket + 16)
        err, ok = _against_plain(kind, q, kc, vc, valid, slot, 7)
        worst[name] = max(worst[name], err)
        wrapper, plain = _wrapper_and_plain(kind)
        L = kc.shape[0]
        main[name] = (device_ms(lambda i: wrapper(q, kc, vc, valid, slot, i % L), calls=L),
                      device_ms(lambda i: plain(q, kc, vc, valid, slot, i % L), calls=L))
        warm = device_ms(lambda i: wrapper(q, kc, vc, valid, slot, 7))
        main_cases.append(f"{kind}(N32/32,B1,Sq{Sq},L32) err={err:.2e} "
                          f"{main[name][0] * 1e3:.1f}us/plain {main[name][1] * 1e3:.1f}us "
                          f"over the 32 layers, {warm * 1e3:.1f}us on one layer")
        if not ok:
            failures.append(main_cases[-1])
        del q, kc, vc
    print(f"[3 kernels] bf16, L=2 S=2048 hd=128, tol atol=rtol={ATOL}: " + "; ".join(cases)
          + "; at the main path's shapes: " + "; ".join(main_cases), flush=True)
    if failures:
        raise RuntimeError(f"kernels disagree with their plain versions: {failures}")
    return {"worst": worst, "main": main}


def phase_slice(smi: str, cfg, tokenizer) -> dict:
    L = cfg.text_config.num_hidden_layers
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = init_random_(VisualCLAModel(cfg, device="cuda", dtype=torch.bfloat16), gen)
    bundle = api.VisualCLA(model, cfg, tokenizer, ImageProcessor(image_size=224),
                           max_seq_len=2048)
    setup_s = time.perf_counter() - t0
    image = random_image(SEED)
    greedy = SamplingConfig.greedy(max_new_tokens=32)

    # the full-width prefill against the same model with plain attention;
    # bf16 rounding through 32 random layers reaches a few % of the logit
    # scale, so bf16 is held loosely (gross errors) and fp32 tightly below
    enc = encoding_text([], PROMPT, bundle.num_patch, tokenizer)
    pv = bundle.image_processor(image)["pixel_values"]
    eng = bundle.engine
    pos = img_marker_positions(enc["input_ids"], tokenizer.img_start_token_id)
    kernel_logits, plain_logits = _kernels_vs_plain_logits(eng, enc["input_ids"], pv, pos)
    if not bool(torch.isfinite(kernel_logits).all()):
        raise RuntimeError("non-finite logits at full width")
    logit_diff = (kernel_logits - plain_logits).abs().max().item()
    logit_scale = plain_logits.abs().max().item()
    if logit_diff > 0.25 * logit_scale:
        raise RuntimeError(f"bf16 full-width logits: kernels vs plain differ by "
                           f"{logit_diff} (scale {logit_scale})")

    api.chat(bundle, image, PROMPT, [], SamplingConfig.greedy(max_new_tokens=4),
             verbose=False)  # warm-up
    torch.cuda.synchronize()

    # the main path's run: one greedy chat, its launches counted from zero
    fa.reset_launch_counts()
    response, _ = api.chat(bundle, image, PROMPT, [], greedy, verbose=False)
    chat_counts = dict(fa.LAUNCHES)
    for name, n in chat_counts.items():
        if n == 0:
            raise RuntimeError(f"kernel {name} was never launched by the main path")
    # the same prompt through generate for its ids: one prefill, then one
    # decode step per token after the first, each through all L layers
    ids = bundle.generate(enc["input_ids"], pixel_values=pv, generation_config=greedy)[0]
    n_gen = len(ids)
    expect = {"flash_prefill": L, "flash_decode": L * (n_gen - 1)}
    if chat_counts != expect:
        raise RuntimeError(f"greedy chat launched {chat_counts}, expected {expect}")

    # greedy chat_in_stream: same ids as generate, same text as chat; TTFT
    # and decode rate from the stream's clock
    ttfts, rates = [], []
    for _ in range(3):
        t_call = time.perf_counter()
        stamps, final = [], ""
        for final, _ in api.chat_in_stream(bundle, image, PROMPT, [], greedy,
                                           verbose=False):
            stamps.append(time.perf_counter())
        ttfts.append(stamps[0] - t_call)
        if len(stamps) > 1:
            rates.append((len(stamps) - 1) / (stamps[-1] - stamps[0]))
    if final.lstrip(" ") != response.lstrip(" "):
        raise RuntimeError(f"chat_in_stream {final!r} != chat {response!r}")
    stream_ids = [int(t[0]) for t in bundle.stream_generate(
        enc["input_ids"], pv, greedy)]
    if stream_ids != [int(t) for t in ids]:
        raise RuntimeError(f"stream ids {stream_ids} != generate ids {ids.tolist()}")

    # the default sampled config (temperature .5, top-k 40, top-p .9,
    # repetition penalty 1.1, no-repeat-ngram 15, up to 512 new tokens)
    t_s = time.perf_counter()
    sampled, _ = api.chat(bundle, image, PROMPT, [], None, verbose=False, seed=SEED)
    sampled_s = time.perf_counter() - t_s
    if not isinstance(sampled, str):
        raise RuntimeError("sampled chat returned no text")

    # B=2 generate: uneven prompts, the shorter left padded with pad ids.
    # bf16 GEMMs round differently at M=1 and M=2, and 32 random layers
    # amplify that, so the batched rows are held to their single-row runs in
    # fp32 on the same weights: prefill logits within 1e-3 of the logit scale
    # and greedy tokens identical.  The bf16 logit difference is reported.
    texts = [PROMPT, "图片里有什么？请回答这个问题，并且详细描述图片中的猫和狗在做什么。"]
    rows = [encoding_text([], t, bundle.num_patch, tokenizer)["input_ids"][0] for t in texts]
    S = max(len(r) for r in rows)
    batch = np.full((2, S), tokenizer.pad_token_id, np.int64)
    for i, r in enumerate(rows):
        batch[i, S - len(r):] = r
    pv2 = np.concatenate([pv, pv], axis=0)
    img_id = tokenizer.img_start_token_id
    out2 = bundle.generate(batch, pixel_values=pv2, generation_config=greedy)
    if out2.shape[0] != 2:
        raise RuntimeError(f"B=2 generate returned {out2.shape}")
    batch_logits = model.text.logits(
        _last_hidden(eng, batch, pv2, img_marker_positions(batch, img_id)))
    b2_diff = 0.0
    for i, r in enumerate(rows):
        single = model.text.logits(
            _last_hidden(eng, r[None], pv, img_marker_positions(r[None], img_id)))
        b2_diff = max(b2_diff, (batch_logits[i] - single[0]).abs().max().item())
    if b2_diff > 0.25 * logit_scale:
        raise RuntimeError(f"bf16 B=2 prefill logits differ from single-row ones by "
                           f"{b2_diff} (scale {logit_scale})")
    model32 = VisualCLAModel(cfg, device="cuda", dtype=torch.float32)
    model32.load_state_dict(model.state_dict())
    bundle32 = api.VisualCLA(model32, cfg, tokenizer, bundle.image_processor,
                             max_seq_len=2048)
    eng32 = bundle32.engine
    k32, p32 = _kernels_vs_plain_logits(eng32, enc["input_ids"], pv, pos)
    logit_diff32 = (k32 - p32).abs().max().item()
    if logit_diff32 > 1e-3 * logit_scale:
        raise RuntimeError(f"fp32 full-width logits: kernels vs plain differ by "
                           f"{logit_diff32} (scale {logit_scale})")
    batch_logits = model32.text.logits(
        _last_hidden(eng32, batch, pv2, img_marker_positions(batch, img_id)))
    b2_diff32 = 0.0
    for i, r in enumerate(rows):
        single = model32.text.logits(
            _last_hidden(eng32, r[None], pv, img_marker_positions(r[None], img_id)))
        b2_diff32 = max(b2_diff32, (batch_logits[i] - single[0]).abs().max().item())
    if b2_diff32 > 1e-3 * logit_scale:
        raise RuntimeError(f"fp32 B=2 prefill logits differ from single-row ones by "
                           f"{b2_diff32} (scale {logit_scale})")
    out32 = bundle32.generate(batch, pixel_values=pv2, generation_config=greedy)
    for i, r in enumerate(rows):
        single = bundle32.generate(r[None], pixel_values=pv, generation_config=greedy)[0]
        got = out32[i, :len(single)]
        if got.tolist() != single.tolist():
            first = int(np.argmax(got != single))
            raise RuntimeError(f"fp32 B=2 row {i} differs from its single-row run at "
                               f"token {first}: {got.tolist()} vs {single.tolist()}")
        if np.any(out32[i, len(single):] != tokenizer.pad_token_id):
            raise RuntimeError(f"fp32 B=2 row {i} continues past its single-row EOS")
    del bundle32, model32
    torch.cuda.empty_cache()
    ttft = statistics.median(ttfts)
    rate = statistics.median(rates)
    print(f"[4 slice] VisualCLA-7B bf16 full width (ViT-L/14 24L, resampler 6L/64q, "
          f"LLaMA-7B 32L vocab {cfg.text_config.vocab_size}), random weights seed {SEED}, "
          f"built in {setup_s:.1f} s; prompt {len(enc['input_ids'][0])} tokens (bucket "
          f"{eng.bucket_len(len(enc['input_ids'][0]))}); prefill logits kernels vs plain max diff "
          f"bf16 {logit_diff:.3e}, fp32 {logit_diff32:.3e} (scale {logit_scale:.2f}); greedy chat {n_gen} tokens, "
          f"stream ids equal; B=2 vs single-row prefill logits max diff bf16 {b2_diff:.3e}, "
          f"fp32 {b2_diff32:.3e}; fp32 B=2 rows equal their single-row runs over "
          f"{greedy.max_new_tokens} tokens; "
          f"sampled chat "
          f"{sampled_s:.2f} s; greedy chat launches {chat_counts}; TTFT {ttft * 1e3:.1f} ms (median of 3, "
          f"preprocess + encode + prefill + first token), B=1 decode {rate:.1f} tok/s; "
          f"card {smi}", flush=True)
    return {"launches": chat_counts, "ttft_ms": ttft * 1e3, "decode_tok_s": rate}


def _kernels_vs_plain_logits(engine, input_ids, pixel_values, img_pos):
    """Last-token prefill logits through the kernels and, on the same model,
    with the plain attention versions swapped in."""
    text = engine.model.text
    kernel = text.logits(_last_hidden(engine, input_ids, pixel_values, img_pos))
    with plain_attention():
        plain = text.logits(_last_hidden(engine, input_ids, pixel_values, img_pos))
    return kernel, plain


def _last_hidden(engine, input_ids, pixel_values, img_pos):
    """Final-normed hidden state (B, 1, H) of each row's last prompt token
    after a prefill into a fresh 2048-slot cache."""
    hidden, *_ = engine.prefill(input_ids, pixel_values, img_pos, 2048)
    return hidden[:, -1:]


def main() -> int:
    info = phase_device()
    phase_build()
    cfg = visualcla_config_for_size("7B")
    tokenizer = make_tokenizer(cfg.text_config.vocab_size)
    prompt_len = len(encoding_text([], PROMPT, cfg.num_image_tokens, tokenizer)["input_ids"][0])
    kern = phase_kernels(pick_bucket(PROMPT_BUCKETS, prompt_len))
    sl = phase_slice(info["smi"], cfg, tokenizer)
    kernels = []
    for name in ("flash_decode", "flash_prefill"):
        ms, plain_ms = kern["main"][name]
        kernels.append({"name": name, "route": "cuda", "source": KERNEL_SOURCE,
                        "replaces": REPLACES[name], "launches": sl["launches"][name],
                        "max_abs_err": kern["worst"][name], "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
