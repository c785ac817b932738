"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one line of findings each:
  1. device  — the card's name and power limit (nvidia-smi), torch and CUDA
               versions; no CUDA device is an error, never a CPU run; the
               in-process tokenizer is saved as a ``tokenizer.model`` and read
               back through ``VisualCLATokenizer.from_pretrained``: the run
               uses the one read from the file;
  2. build   — build the CUDA kernels from ``visualcla_tpu_torch/csrc``, one
               ``nvcc`` per source, all at once;
  3. kernels — each kernel against its plain PyTorch version on the card, with
               device times: B1/B2 in bf16 and with the int8 KV cache at the
               7B head shapes (MHA and GQA) and at the main path's own shapes
               (32 layers, the chat prompt's bucket); B3 (int4 matmul) at the
               7B text tower's shapes for 1, 8 and 512 tokens, per decoder
               layer at the main path's token counts, and both forms on
               each shape at 4-32 tokens beside the one the wrapper picks;
               B4 (paged append attention) with bf16 and
               int8 pools at the 7B heads, B=4 ragged (a parked row, block
               edges; also in a 2048-slot table), GQA and B=8 x 2048, pools
               bitwise equal, each call repeated bit for bit; B5 (paged
               verify attention, the speculative step) at Sq 5 and 9 on the
               same rows (an append across a block edge), GQA and B=8 x 2048,
               running rows' outputs and pools (outside the dummy block 0)
               checked; B6 (paged decode attention, f32) at B4's shapes; B2 at
               Sq 5 and 9 with per-row write slots; B1's split-KV cases (B = 1
               near the end of the cache, a negative slot and a row with
               nothing valid, hd 64, f32, each call twice for bitwise equal
               outputs); B2u (flash attention over
               unstacked K/V) at the ViT's shape (257 tokens, 16 x 64, B=1 and
               8, bf16 and f32), at 448 px (1025 tokens), at the resampler's
               (64 queries over 321 slots) and in the mesh form (bnsh, causal,
               hd 128, per-row slots, bf16 and int8 K/V, a fully masked row)
               and with int8 K/V at the ViT's token counts (hd 64); B1 at
               the beam search's shape (4 rows sharing the chat's prompt,
               slot prompt + 16, 2048 slots, bf16 and f32); B1 at the
               contiguous pool's shape (4 rows at different slots and a
               parked row, 2048 slots, bf16);
               each with its bound and, where one PyTorch call computes the
               same function, that call's time;
  4. slice   — VisualCLA-7B at full width on seeded random bf16 weights made
               on the card: prefill logits through the kernels against the
               plain attention versions (loosely in bf16, tightly on an fp32
               copy of the weights); greedy ``chat``, ``chat_in_stream``
               (same ids), the default sampled ``chat``; a B=2 ``generate``
               of uneven prompts whose rows equal their single-row runs (in
               fp32: bf16 GEMMs round by batch shape); the launch counters
               of the greedy chat alone; TTFT and B=1 decode tokens/s; a
               ``chat_in_stream(chunk_size=4)`` with the same text as ``chat``; a
               greedy speculative chat of 64 tokens on a prompt that invites
               copying (B2 once a layer a verify chunk, B1 never), its
               stream's ids equal to its ``generate``'s, tokens a chunk,
               acceptance, TTFT and decode rate; the first chat's TTFT (its
               captures) beside the warm one; ``Engine.start`` captured
               (first call, warm) and eager, host and device ms, with equal
               launches and first token;
  4b beams  — phase 4's model: a 4-beam greedy ``chat`` of 32 tokens with
               exact launch counts (B2 once a layer for the shared prefill, B1
               once a layer a step at B = 4), the device ms of a beam step
               (torch.profiler) and the chat's tokens/s; ``num_return_sequences
               =2`` (two hypotheses, best first); a sampled 4-beam chat on a
               seeded generator; then on an fp32 copy: beam ids through the
               kernels equal to those under ``plain_kernels()``, the best
               hypothesis's score equal to a teacher-forced rescoring (one
               prefill through B2) within 1e-3, and a batched B=2 beam
               ``generate`` equal to its two single-row runs;
  4f concurrency — phase 4's engine: two greedy streams of one shape that
               meet at the prefill, then a stream beside a B=2 generate that
               captures new graphs: every call's ids equal its sequential
               run's;
  4v vision  — phase 4's model with VISUALCLA_VIT_ATTN=flash: encode_image
               on 1 and 8 images with exactly 30 B2u launches a call, a greedy
               chat with exact B2u / B2 / B1 counts, VisionPipeline on 8
               images, evaluate on the first 8 vendored llava questions,
               device_preprocess against the host processor, the fp32 vision
               towers' embeddings flash vs dense within 1e-4 relative, then
               extend_to_resolution(448) and the same chat (B2u at 1025
               tokens); encode ms and TTFT flash vs dense at 224 and 448 px,
               and ``VisionPipeline``'s captured encode against the eager
               one (first call, warm; host and device ms; equal launches);
               the flash ``Engine.start`` captured and eager;
  5. int4    — the same model made anew, its text tower quantized on the card
               to int4 (``quantize_text_tower_``), with the int8 KV cache:
               prefill logits through the kernels against the plain versions
               of B3 and the int8-K/V attention; greedy ``chat`` with exact
               launch counts, ``chat_in_stream`` (same ids as ``generate``),
               TTFT and B=1 decode tokens/s; a greedy speculative chat (B3 and
               the int8-K/V B2 at K+1 tokens), exact launch counts, and the
               device time of one chunk with B3's forms as the wrapper picks
               them and as the parent commit picked them; ``Engine.start``
               captured and eager;
  6. int8    — the same at the int8 weight tier (bf16 cache): one short
               greedy chat, finite prefill logits, its times;
  7. serve   — paged serving at full width: ``PagedServingEngine`` (4 rows,
               64-token blocks) under the ``Scheduler`` and the HTTP handler on
               127.0.0.1; 8 concurrent requests (4 greedy, 2 of them over
               /chat and /chat_stream; default sampled, TFS, top-a,
               mirostat-2) complete, every block comes back, B4 launches once
               a layer per decode step and B2 once a layer per prefill or
               chunk; decode logits through B4 against its plain version;
               aggregate decode rate and device time a step with 4 rows busy;
               then the speculative pool (``spec_k=4``, same rows): 6 requests
               (4 greedy, 2 of them repetitive; default sampled, TFS) complete
               under the Scheduler with speculative dispatches, B5 launches
               once a layer a speculative iteration, B4 once a layer a plain
               step; its aggregate rate and tokens a speculative step with 4
               rows busy; an fp32 pool of 3 equal to single-stream generation
               token for token, and so are fp32 speculative ``generate`` and
               an fp32 speculative pool of 3;
  7c serve contiguous — ``PoolWorker(paged=False)``, the default
               (``ServingEngine``: 4 rows x 2048 slots, bf16), phase 7's 8
               concurrent requests under the Scheduler and over HTTP, twice
               (the first round captures a graph pair for each sampler's
               flags; the second replays them), exact launches of the
               second (B2 once a layer an admission, B1 once a layer a
               decode pass), the first request's TTFT and both rounds' p50, 4
               busy rows captured and eager (tok/s, device ms a pass, idle
               share), an fp32 pool of 3 equal to single-stream generation;
  8. serve int4 — the int4 tier with the int8 KV pool: 3 requests, exact
               launch counts of B4's int8 form, finite decode logits; then 2
               greedy requests on a speculative int8 pool (B5's int8 form);
               the device time of one decode step of the default 8-row pool,
               B3's forms as the wrapper and as the parent commit pick them;
               3 requests on a contiguous pool at this tier, B3's launches
               by form exactly;
  9. reference layout — phase 4's model made anew (the same seed: the same
               bits), exported with ``export_reference_merged`` in bfloat16
               into a temporary directory with the tokenizer; loaded back
               through ``get_model_and_tokenizer_and_processor`` (state bit
               for bit phase 4's, the greedy chat's ids phase 4's) and
               ``VisionPipeline.from_reference_merged`` (embeddings equal to
               ``encode_image``'s); then the unmerged path on the export's
               ``text_encoder/`` (its embedding and LM head cut by 4 rows, as
               the base LLaMA lacks VisualCLA's added tokens, so the load
               resizes them on the card) and ``vision_encoder/`` with a
               fabricated rank-8 PEFT adapter over every text and vision
               projection (full resampler, projector, and the embedding and
               LM head as ``modules_to_save``): folded weights against an
               independent fp32 fold (at most 1 bf16 ulp), the tables equal
               to the adapter's, a greedy chat with finite logits; seconds,
               GB/s, peak RSS and its private part for each step;
 11. train   — (after 9, before the summary; no hand kernel is on the paths
               of (a)-(d), and their steps must launch none; B3 is on (e)'s)
               (a) a full-width VisualCLA-7B stage-2 QLoRA step
               (``fixtures.train_model``: int8 decoder matmuls, bf16
               embed_tokens / lm_head / vision / resampler / projection,
               bf16 LoRA r=8 on the text and vision targets;
               ``lora_trainable``, remat, constant lr 1e-4) on B=1, S=512
               with ``<img>`` at 2 and the first 80 labels ignored: a warm
               step and 5 timed ones (``make_train_step_subset``): each loss,
               step ms p50 (CUDA events and the host clock), tokens/s, peak
               GB, trainable parameters, the model FLOPs a step reckoned
               from the shapes (``fixtures.train_step_flops``) and their
               share of 989 TFLOP/s (mfu); fails unless every loss is finite
               and the last below the first, every frozen leaf (int8
               carriers and scales included) is bitwise unchanged and every
               trainable leaf changed (but those whose last Adam step is
               below half a bf16 ulp of every value); (b) a stage-1 step at
               full width (bf16 text tower frozen), the same fields and
               checks; (c) the tiny fp32 model's stage-2 step on the card
               against the CPU (TF32 off): loss, grad_norm and parameters
               within rtol 1e-5 / atol 1e-6; (d) ``run_training.main`` on the
               card over a tiny native checkpoint and 4 records (3 steps,
               ``--save_every 2 --remat``), a resume from step_2 equal to
               the run, the output through the factory and a greedy chat, the
               adapter folded by the unmerged loader against the merged
               output within bf16 rounding; (e) stage 1 at full width over
               the frozen int4 text tower (``fixtures.train_model(bits=4)``:
               int4 layers and head, per-row int8 table), remat, 1 warm + 1
               timed step: (b)'s fields and checks (the carriers and scales
               bitwise unchanged), B3's launches exactly 2 x (7 x 32 x 2 + 1)
               (forward, the remat recompute, the head), the head's dX
               through ``Int4MatmulFn`` against ``int4_matmul_grad_ref`` (B3's
               tolerance) with its forward and backward ms, step ms and peak
               beside (b)'s; the tiny fp32 int4 step's gradients on the card
               (B3) against the CPU within INT4_TRAIN_TOL (B3 rounds x to
               bf16); the kernels line's B3 rows gain ``train_launches``;
 12. apps    — (after 4f, on phase 4's model) (a) the Gradio demo's callback
               (``apps.gradio_demo.make_predict``) streamed and blocking with
               the sliders at 32 tokens, top-k 1, top-p .9, temperature .5:
               both answers equal and equal to ``chat``'s with that config,
               exact B2 / B1 launches of the streamed run, no launch and the
               error message without an image, TTFT (first yield) and
               tokens/s beside phase 4's; (b) the webui plugin's
               ``embed_images`` on 2 seeded images over ``VisionPipeline``
               of phase 4's towers: (128, 4096) bf16 on the card, bitwise the
               host round trip (``VisionPipeline.embed_images`` cast back)
               and ``encode_image`` of the same pixels, warm host and device
               ms of both; (c) ``utils.profiling``: the engine's timer over 3
               greedy generates (prefill and decode x3), ``GLOBAL_COUNTERS``
               (tokens, requests, a speculative generate's chunks) and a
               ``trace`` naming B1's and B2's symbols; the parity harness
               needs transformers and the reference's checkout, and runs in
               the CPU tests only;
 13. mesh    — (after 12) serving over a device mesh at world size 1 over
               NCCL (a file store, no network): (a) ``distributed.
               initialize``; (b) the factory over a (data 1, model 1) mesh
               on a copy of phase 4's model: greedy chat, generate,
               ``chat_in_stream``, speculative and 4-beam ids bitwise the
               unmeshed bundle's, exact B1 / B2 launches, the collectives a
               chat (``parallel.tp.CALLS``), TTFT and B=1 tok/s beside phase
               4's, a profiled generate's collectives and graph launches,
               and the device work its collectives add to the unmeshed
               run's (at least one copy a gather); a data rank's sampled
               row window (``global_rows``) and unsplit calls on one
               engine, each equal to the unmeshed eager call's;
               (c) ``PagedServingEngine(mesh=)``, 4
               rows, bf16 then int8 pools: ids equal the unmeshed pools',
               exact B4 launches, device ms a pass; (d) each kernel at the
               shard shapes of one rank of a TP = 2, 4 and 8 7B (B1 / B2 at
               32/nm heads, B2u's mesh form through ``_flash_sharded`` under
               the (1, 1) mesh's scope, the ViT at 16/nm heads, B3's two
               forms at 1 and 512 tokens on the rank's int4 carriers, B4 at
               32/nm heads) against its plain version, with its bound, plain
               and library times (summary rows ``*_tp2`` .. ``*_tp8``); (e) a
               (data 1, seq 1) mesh: the ring prefill of a 2048-token prompt,
               each layer's ring output against B2's on the same q/k/v, the
               captured run's ids equal the eager one's, and an fp32
               2-layer copy's ids equal the unmeshed engine's; (f) a meshed
               model served through ``PoolWorker`` -> ``Scheduler`` -> the
               contiguous pool and the paged int8-KV pool (speculating):
               4 requests one at a time with ids equal the unmeshed
               worker's, 8 concurrent /chat_stream requests over HTTP (all
               answered, exact B2 / B1 / B4 / B5 launches, TTFT p50 / max,
               aggregate tok/s), and the contiguous pool by direct calls
               over the mesh with ids equal the unmeshed pool's (summary
               rows gain ``scheduler_mesh_launches``);
 14. mesh train — (after 11) training over a device mesh at world size 1
               over NCCL at the 7B's full width: (a) ``parallel.pipeline``'s
               cached form on a seeded bf16 32-layer text tower over a
               (pipe 1, data 1) mesh, B = 2, a 512-token prefill and 16
               decode steps, with a bf16 and an int8 cache: n_micro 1
               bitwise ``Llama.forward`` (hidden states and cache), n_micro 2
               bitwise two B = 1 unmeshed runs, exactly 32 x M B2 launches a
               prefill and 32 x M B1 launches a step, device ms a pass
               beside the unmeshed pass's; (b) phase 11's 7B QLoRA stage-2
               step on a (data 1, model 1) mesh (LoRA over the TP layers),
               as is and with ``fsdp=True``, against the unmeshed step on
               the same seed and batch (loss and grad_norm within
               MESH_TRAIN_RTOL), with host and device ms, peak memory and
               the collectives a step; (c) the same step with
               ``pipeline_mesh`` (pipe 1, data 1), n_micro 2, B = 2, against
               the unmeshed step at B = 2 (within PIPE_TRAIN_RTOL);
 15. jamba  — (after 14) kernels B7 and B8 at the Jamba2-Mini cell's shapes
               against their plain versions, with device times, bounds and
               plain times: B7 over one MoE layer (16 experts, 4096 ->
               2 x 14336 -> 4096) at a 32-row decode pass with 32, 14 and 8
               rows running (the rest routed to no expert, as the MoE routes
               them) and at 256-token admission chunks (all real, 120 real);
               B8 over one Mamba layer (D 8192, N 16) in its chunk form (256
               and 120 real tokens) and its step form (32 rows, 32 / 14 / 8
               running; idle rows' states unchanged bit for bit); then a
               Jamba tower of the cell's layer pattern at width 512 (int4,
               int8 K/V) served by ``PoolWorker(paged=True)``: 6 concurrent
               chats after a warm-up, with exact launches of B7 (2 a MoE
               layer and pass), B8 (2 a Mamba layer and pass), B4 and B2
               against the engine's passes (the kernels line's B7 / B8 rows);
 10. the seconds each phase took, the kernel summary as one JSON line, then
     the result line.
Exits non-zero if any phase fails.  Needs no network and no JAX.
"""
from __future__ import annotations

import base64
import contextlib
import shutil
import dataclasses
import gc
import io
import json
import math
import resource
import statistics
import subprocess
import os
import sys
import tempfile
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from visualcla_tpu_torch.core.config import JambaConfig, visualcla_config_for_size
from visualcla_tpu_torch.processor import ImageProcessor
from visualcla_tpu_torch.text import VisualCLATokenizer
from visualcla_tpu_torch.text.prompt import encoding_text, img_marker_positions
from visualcla_tpu_torch import api
from visualcla_tpu_torch.apps import gradio_demo
from visualcla_tpu_torch.apps import serve as serve_app
from visualcla_tpu_torch.apps.evaluate import evaluate
from visualcla_tpu_torch.assets import golden_path
from visualcla_tpu_torch.checkpoint.export import export_reference_merged
from visualcla_tpu_torch.checkpoint.from_jax import params_to_jax
from visualcla_tpu_torch.checkpoint.mapping import sd_from_tower_leaves
from visualcla_tpu_torch.engine import beam as beam_mod
from visualcla_tpu_torch.engine import graphs as graphs_mod
from visualcla_tpu_torch.engine import paged as paged_mod
from visualcla_tpu_torch.engine import server as server_mod
from visualcla_tpu_torch.engine.generate import PROMPT_BUCKETS, Engine, pick_bucket
from visualcla_tpu_torch.engine.sampling import SamplingConfig, global_rows
from visualcla_tpu_torch.integrations.text_generation_webui.visualcla_torch_pipeline import (
    visualcla as webui_plugin)
from visualcla_tpu_torch.fixtures import (PROMPT, SEED, make_tokenizer, paged_case,
                                          paged_decode_args, paged_verify_case, plain_kernels,
                                          random_image)
from visualcla_tpu_torch.models import jamba as jamba_mod
from visualcla_tpu_torch.models import llama as llama_mod
from visualcla_tpu_torch.models.resampler import Resampler
from visualcla_tpu_torch.models.visualcla import (VisionTowers, VisualCLAModel, encode_image,
                                                  init_random_, multimodal_embeds,
                                                  quantize_text_tower_)
from visualcla_tpu_torch.ops.cuda import build
from visualcla_tpu_torch.ops.cuda import flash_attention as fa
from visualcla_tpu_torch.ops.cuda import int4_matmul as i4
from visualcla_tpu_torch.ops.cuda import paged_attention as pa
from visualcla_tpu_torch.ops.cuda import moe_int4 as b7
from visualcla_tpu_torch.ops.cuda import selective_scan as b8
from visualcla_tpu_torch.ops.cuda.bench_int4 import CROSSOVER_TOKENS
from visualcla_tpu_torch.ops.attention import attention_mesh_scope, cached_attention
from visualcla_tpu_torch.ops.quantization import dequantize_grouped, quantize_grouped, quantize_kv
from visualcla_tpu_torch.parallel import distributed
from visualcla_tpu_torch.parallel import tp as tp_mod
from visualcla_tpu_torch.parallel.sharding import make_mesh
from visualcla_tpu_torch.pipeline import CapturedEncode, VisionPipeline
from visualcla_tpu_torch.processor.image import device_preprocess
from visualcla_tpu_torch.utils import profiling

ATOL = RTOL = 2e-2  # bf16 output rounding plus another summation order
F32_TOL = 1e-4  # f32 inputs: another summation order only
# bf16 image embeddings through B2u against the plain versions, relative to
# their largest value: 30 layers of bf16 rounding in another order
EMBED_REL_TOL = 5e-2
# B3 against its plain version in fp32 on the same bf16 x and carrier:
# |err| <= B3_TOL * max|ref| + B3_TOL * |ref| (the prefill form rounds the
# dequantized weight to bf16, as the TPU's scratch form does)
B3_TOL = 1e-2
FLASH_SOURCE = "visualcla_tpu_torch/csrc/flash_attention.cu"
INT4_SOURCE = "visualcla_tpu_torch/csrc/int4_matmul.cu"
PAGED_SOURCE = "visualcla_tpu_torch/csrc/paged_attention.cu"
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "flash_decode": (FLASH_SOURCE, "visualcla_tpu/ops/pallas/flash_attention.py:120"),
    "flash_prefill": (FLASH_SOURCE, "visualcla_tpu/ops/pallas/flash_attention.py:29"),
    # B1 at the beam search's shape (its launches: phase 4b's beam chat)
    "flash_decode_beam4": (FLASH_SOURCE, "visualcla_tpu/ops/pallas/flash_attention.py:120"),
    # B1 at the contiguous pool's shape (its launches: phase 7c's serve)
    "flash_decode_pool": (FLASH_SOURCE, "visualcla_tpu/ops/pallas/flash_attention.py:120"),
    "flash_decode_kv8": (FLASH_SOURCE, "visualcla_tpu/ops/pallas/flash_attention.py:120"),
    "flash_prefill_kv8": (FLASH_SOURCE, "visualcla_tpu/ops/pallas/flash_attention.py:29"),
    "flash_full": (FLASH_SOURCE, "visualcla_tpu/ops/pallas/flash_attention.py:308"),
    "flash_full_kv8": (FLASH_SOURCE, "visualcla_tpu/ops/pallas/flash_attention.py:308"),
    "int4_matmul_decode": (INT4_SOURCE, "visualcla_tpu/ops/pallas/int4_matmul.py:85"),
    "int4_matmul_prefill": (INT4_SOURCE, "visualcla_tpu/ops/pallas/int4_matmul.py:172"),
    "paged_append": (PAGED_SOURCE, "visualcla_tpu/ops/pallas/paged_attention.py:261"),
    "paged_append_kv8": (PAGED_SOURCE, "visualcla_tpu/ops/pallas/paged_attention.py:261"),
    "paged_verify": (PAGED_SOURCE, "visualcla_tpu/ops/pallas/paged_attention.py:589"),
    "paged_verify_kv8": (PAGED_SOURCE, "visualcla_tpu/ops/pallas/paged_attention.py:589"),
    "paged_decode": (PAGED_SOURCE, "visualcla_tpu/ops/pallas/paged_attention.py:56"),
    "paged_decode_kv8": (PAGED_SOURCE, "visualcla_tpu/ops/pallas/paged_attention.py:56"),
}
# B6 has no caller in either package: its launches are an op-level pass over
# the 32 layers in phase 3, and its summary row says so
B6_NOTE = ("launches: one op-level pass over the 32 layers at the B=4 shape (no path of "
           "the package calls B6)")
# B2u's int8 form is reached only by the mesh form of cached attention
B2U_KV8_NOTE = ("launches: one op-level pass of cached_attention(layer_index=None) over the 32 "
                "layers of an int8 cache at the mesh form's shape (no single-device path of "
                "either package calls B2u's int8 form)")
SPEC_K = 4  # the serve phases' speculative pools: B5 at Sq = SPEC_K + 1
BEAMS = 4  # phase 4b's beam search, and B1's beam-shape case in phase 3
# the card's published peaks (H100 SXM data sheet): the least time a call can
# take is the larger of its bytes over the memory rate and its operations
# over the bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12  # outside the tensor cores
# the 7B text tower's int4 matmuls, (in, out): one decoder layer, and the head
LAYER_SHAPES = {"q_proj": (4096, 4096), "k_proj": (4096, 4096), "v_proj": (4096, 4096),
                "o_proj": (4096, 4096), "gate_proj": (4096, 11008),
                "up_proj": (4096, 11008), "down_proj": (11008, 4096)}
HEAD_SHAPE = (4096, 49958)
# the parent commit's choice of B3's form, timed beside ``i4.decode_form``'s
# on the int4 decode and speculative steps (both on this tree's kernels): its
# cost model, fitted to its two-launch decode form of 1-8-token slices
PARENT_DECODE_COLUMNS_PER_SM = 83
PARENT_DECODE_SLICE_COST = {1: 0.32, 2: 0.45, 4: 0.64, 8: 1.0}


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


def event_ms(fn, n: int = 5) -> float:
    """Time of one ``fn()`` from CUDA events around ``n`` calls, launches
    included: for work a CUDA graph cannot capture (host-to-device copies)."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def bound(nbytes: float, ops: float, ops_per_s: float = BF16_OPS_PER_S):
    """(least ms, what bounds it) for a call moving ``nbytes`` and doing
    ``ops`` operations at ``ops_per_s`` (bf16 tensor cores by default)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


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
    build.build(["flash_attention", "int4_matmul", "paged_attention", "moe_int4",
                 "selective_scan"])
    for kernels in (fa, i4, pa, b7, b8):
        kernels.build_kernels()
    nvcc = ", ".join(f"{k}.cu {v:.2f} s" for k, v in build.build_seconds.items())
    print(f"[2 build] flash_attention.cu, int4_matmul.cu, paged_attention.cu, moe_int4.cu and "
          f"selective_scan.cu built in parallel and loaded in "
          f"{time.perf_counter() - t0:.2f} s (nvcc: {nvcc})", flush=True)


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


def _quantized_cache(kc, vc):
    """The int8 KV cache of the same values: (k, v, {"k_scale", "v_scale"})."""
    (kq, ks), (vq, vs) = quantize_kv(kc), quantize_kv(vc)
    return kq, vq, {"k_scale": ks, "v_scale": vs}


def _against_plain(kind, q, kc, vc, valid, slot, layer, scales=None):
    """The kernel's output against its plain version, computed in fp32 from
    the same bf16 (or int8) inputs: (max abs error, within tolerance and
    finite)."""
    wrapper, plain = _wrapper_and_plain(kind)
    scales = scales or {}
    out = wrapper(q, kc, vc, valid, slot, layer, **scales)
    torch.cuda.synchronize()
    if scales:
        ref = plain(q.float(), kc, vc, valid, slot, layer, **scales)
    else:
        ref = plain(q.float(), kc.float(), vc.float(), valid, slot, layer)
    err = (out.float() - ref).abs()
    ok = bool((err <= ATOL + RTOL * ref.abs()).all()) and bool(torch.isfinite(out).all())
    if kind == "decode" and q.shape[0] == 8:
        ok = ok and bool((out[5] == 0).all())  # the fully masked row
    return err.max().item(), ok


def phase_kernels(prompt_bucket: int, prompt_len: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = {name: 0.0 for name in KERNELS}
    main, lines, failures = {}, [], []
    for kv8 in (False, True):
        suffix = "_kv8" if kv8 else ""
        cases = []
        for N, Nkv in ((32, 32), (32, 8)):
            for kind, shapes in (("prefill", [(B, Sq) for Sq in (256, 2048) for B in (1, 2)]),
                                 ("decode", [(B, 1) for B in (1, 8)])):
                name = "flash_" + kind + suffix
                for B, Sq in shapes:
                    q, kc, vc, valid, slot = _kernel_case(kind, B, Sq, N, Nkv, gen)
                    sc = {}
                    if kv8:
                        kc, vc, sc = _quantized_cache(kc, vc)
                    wrapper, plain = _wrapper_and_plain(kind)
                    err, ok = _against_plain(kind, q, kc, vc, valid, slot, 1, sc)
                    worst[name] = max(worst[name], err)
                    ms = device_ms(lambda i: wrapper(q, kc, vc, valid, slot, 1, **sc))
                    plain_ms = device_ms(lambda i: plain(q, kc, vc, valid, slot, 1, **sc),
                                         calls=2)
                    cases.append(f"{kind}(N{N}/{Nkv},B{B},Sq{Sq}) err={err:.2e} "
                                 f"{ms * 1e3:.1f}us/plain {plain_ms * 1e3:.1f}us")
                    if not ok:
                        failures.append(name + " " + cases[-1])
                    del q, kc, vc, sc
        # the main path's shapes: the B=1 chat prompt's bucket in the default
        # 2048-slot cache of all 32 layers; decode 16 tokens into the answer.
        # Checked at layer 7, then timed two ways: over all 32 layers in
        # turn, as a decode step reads them (each layer's K/V comes from
        # HBM), and on layer 7 alone (its K/V stays in the 50 MB L2)
        main_cases = []
        for kind, B, Sq in (("prefill", 1, prompt_bucket), ("decode", 1, 1)):
            name = "flash_" + kind + suffix
            q, kc, vc, valid, slot = _kernel_case(kind, B, Sq, 32, 32, gen, L=32,
                                                  slot0=prompt_bucket + 16)
            sc = {}
            if kv8:
                kc, vc, sc = _quantized_cache(kc, vc)
            err, ok = _against_plain(kind, q, kc, vc, valid, slot, 7, sc)
            worst[name] = max(worst[name], err)
            wrapper, plain = _wrapper_and_plain(kind)
            L = kc.shape[0]
            main[name] = {
                "ms": device_ms(lambda i: wrapper(q, kc, vc, valid, slot, i % L, **sc),
                                calls=L),
                "plain_ms": device_ms(lambda i: plain(q, kc, vc, valid, slot, i % L, **sc),
                                      calls=L),
                **_flash_bound_and_library(kind, q, kc, vc, valid, slot, sc)}
            warm = device_ms(lambda i: wrapper(q, kc, vc, valid, slot, 7, **sc))
            m = main[name]
            lib = "none" if m["library_ms"] is None else f"{m['library_ms'] * 1e3:.1f}us"
            main_cases.append(f"{kind}(N32/32,B1,Sq{Sq},L32) err={err:.2e} "
                              f"{m['ms'] * 1e3:.1f}us/plain {m['plain_ms'] * 1e3:.1f}us "
                              f"over the 32 layers, {warm * 1e3:.1f}us on one layer; bound "
                              f"{m['bound_ms'] * 1e3:.2f}us ({m['bound_by']}); "
                              f"scaled_dot_product_attention {lib}")
            if not ok:
                failures.append(name + " " + main_cases[-1])
            del q, kc, vc, sc
        lines.append(f"[3 kernels] B1/B2 {'int8 K/V' if kv8 else 'bf16'}, L=2 S=2048 hd=128, "
                     f"tol atol=rtol={ATOL}: " + "; ".join(cases)
                     + "; at the main path's shapes: " + "; ".join(main_cases))
        print(lines[-1], flush=True)
    b3_main, b3_line = _b3_cases(gen, prompt_bucket, worst, failures)
    main.update(b3_main)
    print(b3_line, flush=True)
    main.update(_b4_cases(worst, failures))
    main.update(_b5_cases(worst, failures))
    b6_main, b6_launches = _b6_cases(worst, failures)
    main.update(b6_main)
    _b2_verify_case(gen, worst, failures)
    _b1_split_cases(gen, worst, failures)
    main.update(_b1_beam_cases(gen, prompt_len, worst, failures))
    main.update(_b1_pool_cases(gen, worst, failures))
    b2u_main, b2u_launches = _b2u_cases(gen, worst, failures)
    main.update(b2u_main)
    if failures:
        raise RuntimeError(f"kernels disagree with their plain versions: {failures}")
    return {"worst": worst, "main": main, "op_launches": {**b6_launches, **b2u_launches}}


def _flash_bound_and_library(kind, q, kc, vc, valid, slot, sc, ops_per_s=BF16_OPS_PER_S):
    """B1/B2 at the main path's shapes (one layer a call): the bound from
    the K/V slots the call must read (a decode reads the slots up to its
    query's, a prefill the prompt's) and the time of the one PyTorch call
    that computes the same attention, ``scaled_dot_product_attention``, over
    the 32 layers in turn (bf16 cache only: it takes no int8 K/V)."""
    B, Sq, N, hd = q.shape
    Nkv = kc.shape[2]
    n_kv = int(slot[0]) + 1 if kind == "decode" else Sq
    kv_bytes = 2 * B * Nkv * n_kv * hd * kc.element_size()
    if sc:
        kv_bytes += 2 * B * Nkv * n_kv * 4
    pairs = B * N * (n_kv if kind == "decode" else Sq * (Sq + 1) // 2)
    b_ms, b_by = bound(2 * nbytes(q) + kv_bytes + nbytes(valid), 4 * hd * pairs, ops_per_s)
    if sc:
        return {"bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    L = kc.shape[0]
    qt = q.transpose(1, 2)
    if kind == "decode":
        mask = valid[:, None, None, :n_kv]
        lib = device_ms(lambda i: F.scaled_dot_product_attention(
            qt, kc[i % L][:, :, :n_kv], vc[i % L][:, :, :n_kv], attn_mask=mask), calls=L)
    else:
        lib = device_ms(lambda i: F.scaled_dot_product_attention(
            qt, kc[i % L][:, :, :Sq], vc[i % L][:, :, :Sq], is_causal=True), calls=L)
    return {"bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}


def _b4_case_bytes(case) -> tuple:
    """(bytes, operations) B4 must move and do on this case: q, the new
    K/V, every row's old context (and its int8 scales) read once, the output
    and the appended K/V written once."""
    q, kp = case["q"], case["k_pool"]
    B, N, hd = q.shape
    Nkv = case["k_new"].shape[1]
    ctx = int((case["lens"] - 1).sum())
    per_token = 2 * Nkv * hd * kp.element_size() + (2 * Nkv * 4 if kp.dtype == torch.int8 else 0)
    new = nbytes(case["k_new"], case["v_new"], case.get("k_new_scales"),
                 case.get("v_new_scales"))
    moved = (2 * nbytes(q) + 2 * new + ctx * per_token
             + nbytes(case["tables"], case["lens"], case["blk"], case["off"]))
    return moved, 4 * hd * N * int(case["lens"].sum())


POOL_KEYS = ("k_pool", "v_pool", "k_scales", "v_scales")


def _paged_check(wrapper, plain, case, rows, pool_from=0):
    """A paged kernel against its plain version on a copy of the same inputs:
    (max abs error over ``rows``, whether those rows are within the
    tolerance and finite and the pools (and scales) from block ``pool_from``
    on bitwise equal)."""
    ref_case = {k: (v.clone() if k in POOL_KEYS and v is not None else v)
                for k, v in case.items()}
    out = wrapper(**case)
    torch.cuda.synchronize()
    ref = plain(**ref_case)
    got, want = out[rows].float(), ref[rows].float()
    err = (got - want).abs()
    ok = (bool((err <= ATOL + RTOL * want.abs()).all()) and bool(torch.isfinite(got).all())
          and all(torch.equal(case[k][:, pool_from:], ref_case[k][:, pool_from:])
                  for k in POOL_KEYS if case.get(k) is not None))
    return err.max().item(), ok


def _b4_cases(worst, failures) -> dict:
    """B4 against its plain version on the card, float (bf16) and int8
    pools, 7B heads (hd 128, BS 64, L 32, layer 7): B=4 rows of ragged
    lengths around 330 (offsets 0 and BS-1, and a parked row: lens 1, dummy
    block 0), the same rows in a table 2048 slots wide (the serve phase's:
    most runs empty), MHA and GQA (8 kv heads), and B=8 x 2048; outputs
    within the tolerance, pools and scales after the call bitwise equal, a
    call repeated on the same pools bitwise equal.  Times over the 32 layers
    in turn.  -> the main-path entries (B=4 ragged, MHA)."""
    main, cases = {}, []
    ragged = [320, 383, 330, -1]
    for kv8 in (False, True):
        name = "paged_append_kv8" if kv8 else "paged_append"
        for label, ctx, Nkv in (("B4 ragged", ragged, 32), ("B4 ragged, 2048-slot table", ragged, 32),
                                ("B4 ragged GQA", ragged, 8), ("B8x2048", [2047] * 8, 32)):
            case = paged_case(ctx, 32, Nkv, L=32, layer=7, dtype=torch.bfloat16, kv_int8=kv8,
                              device="cuda", seed=SEED + len(cases))
            if "2048-slot" in label:
                case["tables"] = F.pad(case["tables"], (0, 32 - case["tables"].shape[1]))
            err, ok = _paged_check(pa.paged_append_attention, pa.paged_append_attention_ref,
                                   case, slice(None))
            repeat = torch.equal(pa.paged_append_attention(**case),
                                 pa.paged_append_attention(**case))
            worst[name] = max(worst[name], err)
            L = case["k_pool"].shape[0]
            ms = device_ms(lambda i: pa.paged_append_attention(**{**case, "layer": i % L}),
                           calls=L)
            plain_ms = device_ms(
                lambda i: pa.paged_append_attention_ref(**{**case, "layer": i % L}), calls=2)
            b_ms, b_by = bound(*_b4_case_bytes(case))
            cases.append(f"{'int8' if kv8 else 'bf16'} {label} (N32/{Nkv}) err={err:.2e} "
                         f"pools bitwise {'equal' if ok else 'DIFFER'}, repeat "
                         f"{'bitwise' if repeat else 'DIFFERS'} {ms * 1e3:.1f}us/plain "
                         f"{plain_ms * 1e3:.1f}us, bound {b_ms * 1e3:.2f}us ({b_by}, "
                         f"{100 * b_ms / ms:.1f} % of it)")
            if not (ok and repeat):
                failures.append(name + " " + cases[-1])
            if label == "B4 ragged":
                main[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                              "bound_by": b_by, "library_ms": None}
            del case
            torch.cuda.empty_cache()
    print(f"[3 kernels] B4 paged append attention (split-KV over the old context, the new "
          f"token folded in by the combine), hd 128 BS 64 L 32 layer 7, tol atol=rtol={ATOL}, "
          f"times over the 32 layers in turn; no single PyTorch call appends into a block pool "
          f"and attends, so no library time: " + "; ".join(cases), flush=True)
    return main


def _b5_case_bytes(case) -> tuple:
    """(bytes, operations) B5 must move and do: q, every row's old context
    (and its int8 scales) and the new K/V read once, the output and the
    appended K/V written once; query j of a row scores lens - Sq + j + 1
    slots."""
    q, kp = case["q"], case["k_pool"]
    B, Sq, N, hd = q.shape
    Nkv = case["k_new"].shape[2]
    base = case["lens"].long() - Sq
    per_token = 2 * Nkv * hd * kp.element_size() + (2 * Nkv * 4 if kp.dtype == torch.int8 else 0)
    new = nbytes(case["k_new"], case["v_new"], case.get("k_new_scales"),
                 case.get("v_new_scales"))
    moved = (2 * nbytes(q) + 2 * new + int(base.sum()) * per_token
             + nbytes(case["tables"], case["lens"]))
    pairs = int((Sq * base + Sq * (Sq + 1) // 2).sum())
    return moved, 4 * hd * N * pairs


def _b5_cases(worst, failures) -> dict:
    """B5 against its plain version, bf16 and int8 pools, 7B heads (hd 128,
    BS 64, L 32, layer 7): B=4 rows of old contexts 318/383/330 and a parked
    row (lens Sq, zeroed table) at Sq 5 (row 0's append crosses a block edge:
    318 % 64 = 62) and Sq 9, GQA (8 kv heads) at Sq 9, and B=8 x 2048 at Sq 9;
    the running rows' outputs within the tolerance, the pools and scales
    after the call bitwise equal outside the dummy block 0 (parked rows all
    write it).  Times over the 32 layers in turn.  -> the main-path entries
    (B=4, Sq = SPEC_K + 1, MHA: the serve phase's verify)."""
    main, cases = {}, []
    ragged = [318, 383, 330, -1]
    for kv8 in (False, True):
        name = "paged_verify_kv8" if kv8 else "paged_verify"
        for label, ctx, Sq, Nkv in (("B4 ragged", ragged, SPEC_K + 1, 32),
                                    ("B4 ragged", ragged, 9, 32),
                                    ("B4 ragged GQA", ragged, 9, 8),
                                    ("B8x2048", [2048 - 9] * 8, 9, 32)):
            case = paged_verify_case(ctx, Sq, 32, Nkv, L=32, layer=7, dtype=torch.bfloat16,
                                     kv_int8=kv8, device="cuda", seed=SEED + 50 + len(cases))
            rows = [b for b, c in enumerate(ctx) if c >= 0]
            err, ok = _paged_check(pa.paged_verify_attention, pa.paged_verify_attention_ref,
                                   case, rows, pool_from=1)
            worst[name] = max(worst[name], err)
            L = case["k_pool"].shape[0]
            ms = device_ms(lambda i: pa.paged_verify_attention(**{**case, "layer": i % L}),
                           calls=L)
            plain_ms = device_ms(
                lambda i: pa.paged_verify_attention_ref(**{**case, "layer": i % L}), calls=2)
            b_ms, b_by = bound(*_b5_case_bytes(case))
            cases.append(f"{'int8' if kv8 else 'bf16'} {label} Sq{Sq} (N32/{Nkv}) err={err:.2e} "
                         f"pools bitwise {'equal' if ok else 'DIFFER'} {ms * 1e3:.1f}us/plain "
                         f"{plain_ms * 1e3:.1f}us, bound {b_ms * 1e3:.2f}us ({b_by}, "
                         f"{100 * b_ms / ms:.1f} % of it)")
            if not ok:
                failures.append(name + " " + cases[-1])
            if label == "B4 ragged" and Sq == SPEC_K + 1:
                main[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                              "bound_by": b_by, "library_ms": None}
            del case
            torch.cuda.empty_cache()
    print(f"[3 kernels] B5 paged verify attention (append of Sq tokens + causal attention), "
          f"hd 128 BS 64 L 32 layer 7, tol atol=rtol={ATOL} on the running rows, times over "
          f"the 32 layers in turn; no single PyTorch call appends into a block pool and "
          f"attends, so no library time: " + "; ".join(cases), flush=True)
    return main


def _b6_cases(worst, failures):
    """B6 against its f32 plain version at B4's shapes (its bf16 or int8 pool
    layer 7 of 32, lens counting every old token; the parked row has lens 0
    and must give zeros), then one op-level pass over the 32 layers with the
    launch counter from zero.  -> (main-path entries at B=4 MHA, the pass's
    launches)."""
    main, cases, launches = {}, [], {}
    ragged = [320, 383, 330, -1]
    for kv8 in (False, True):
        name = "paged_decode_kv8" if kv8 else "paged_decode"
        for label, ctx, Nkv in (("B4 ragged", ragged, 32), ("B4 ragged GQA", ragged, 8),
                                ("B8x2048", [2047] * 8, 32)):
            case = paged_case(ctx, 32, Nkv, L=32, layer=7, dtype=torch.bfloat16, kv_int8=kv8,
                              device="cuda", seed=SEED + 70 + len(cases))
            args = paged_decode_args(case)
            err, ok = _paged_check(pa.paged_decode_attention, pa.paged_decode_attention_ref,
                                   args, slice(None))
            parked = [b for b, c in enumerate(ctx) if c < 0]
            out = pa.paged_decode_attention(**args)
            ok = ok and bool((out[parked] == 0).all())
            worst[name] = max(worst[name], err)
            L = case["k_pool"].shape[0]
            ms = device_ms(lambda i: pa.paged_decode_attention(**paged_decode_args(case, i % L)),
                           calls=L)
            plain_ms = device_ms(
                lambda i: pa.paged_decode_attention_ref(**paged_decode_args(case, i % L)),
                calls=2)
            _, N, hd = args["q"].shape
            kv = args["k_pool"]
            per_token = 2 * kv[0, 0].numel() * kv.element_size() + (
                2 * kv.shape[2] * 4 if kv8 else 0)
            n_ctx = int(args["lens"].sum())
            b_ms, b_by = bound(2 * nbytes(args["q"]) + n_ctx * per_token
                               + nbytes(args["tables"], args["lens"]), 4 * hd * N * n_ctx)
            cases.append(f"{'int8' if kv8 else 'bf16'} {label} (N32/{Nkv}) err={err:.2e} "
                         f"{ms * 1e3:.1f}us/plain {plain_ms * 1e3:.1f}us, bound "
                         f"{b_ms * 1e3:.2f}us ({b_by}, {100 * b_ms / ms:.1f} % of it)")
            if not ok:
                failures.append(name + " " + cases[-1])
            if label == "B4 ragged":
                main[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                              "bound_by": b_by, "library_ms": None}
                torch.cuda.synchronize()
                pa.reset_launch_counts()
                for layer in range(L):
                    pa.paged_decode_attention(**paged_decode_args(case, layer))
                torch.cuda.synchronize()
                launches[name] = pa.LAUNCHES[name]
            del case, args
            torch.cuda.empty_cache()
    print(f"[3 kernels] B6 paged decode attention (f32 arithmetic, no append), hd 128 BS 64, "
          f"layer 7 of 32, tol atol=rtol={ATOL}, the parked row zeros, times over the 32 "
          f"layers in turn, no library time (no single PyTorch call reads a block pool): "
          + "; ".join(cases) + f"; op-level pass launches {launches}", flush=True)
    return main, launches


def _b2_verify_case(gen, worst, failures) -> None:
    """B2 at the speculative chunks' shapes: Sq 5 and 9 queries a row at
    per-row write slots 600 and 700 (B=2, ragged left padding), bf16 and int8
    K/V, against its plain version."""
    cases = []
    for Sq in (SPEC_K + 1, 9):
        for kv8 in (False, True):
            q, kc, vc, _, _ = _kernel_case("prefill", 2, Sq, 32, 32, gen)
            slot = torch.tensor([600, 700], dtype=torch.int32, device="cuda")
            valid = torch.arange(kc.shape[3], device="cuda")[None, :] < slot[:, None].long() + Sq
            valid[0, :3], valid[1, :40] = False, False
            sc = {}
            if kv8:
                kc, vc, sc = _quantized_cache(kc, vc)
            err, ok = _against_plain("prefill", q, kc, vc, valid, slot, 1, sc)
            name = "flash_prefill_kv8" if kv8 else "flash_prefill"
            worst[name] = max(worst[name], err)
            ms = device_ms(lambda i: fa.flash_prefill_stacked(q, kc, vc, valid, slot, 1, **sc))
            cases.append(f"Sq{Sq} {'int8 K/V' if kv8 else 'bf16'} err={err:.2e} "
                         f"{ms * 1e3:.1f}us")
            if not ok:
                failures.append(name + " per-row slots " + cases[-1])
    print(f"[3 kernels] B2 at the speculative chunks' shapes (B=2, write slots 600/700, "
          f"N32, S 2048; a 64-row query tile is mostly padding there), tol atol=rtol={ATOL}: "
          + "; ".join(cases), flush=True)


def _b1_split_cases(gen, worst, failures) -> None:
    """B1's split-KV cases against the plain version: B = 1 at slot 2040 of
    the 2048-slot, 32-layer cache (16 active splits; timed over the layers,
    with its bound and ``scaled_dot_product_attention``), B = 8 at ragged
    slots with a negative slot (row 3) and a row with nothing valid (row 5:
    both zeros), hd 64 (B = 2, 16 heads), and the f32 instance; each called
    twice on the same inputs for bitwise equal outputs."""
    cases = []

    def one(label, q, kc, vc, valid, slot, layer, sc, zero_rows=(), timed=False):
        name = "flash_decode_kv8" if sc else "flash_decode"
        out = fa.flash_decode_stacked(q, kc, vc, valid, slot, layer, **sc)
        again = fa.flash_decode_stacked(q, kc, vc, valid, slot, layer, **sc)
        torch.cuda.synchronize()
        ref = fa.flash_decode_stacked_ref(q.float(), kc if sc else kc.float(),
                                          vc if sc else vc.float(), valid, slot, layer, **sc)
        tol = ATOL if q.dtype == torch.bfloat16 else F32_TOL
        err = (out.float() - ref).abs()
        ok = (bool((err <= tol + tol * ref.abs()).all()) and bool(torch.isfinite(out).all())
              and torch.equal(out, again) and all(bool((out[b] == 0).all()) for b in zero_rows))
        if q.dtype == torch.bfloat16:
            worst[name] = max(worst[name], err.max().item())
        text = f"{label} err={err.max().item():.2e} twice bitwise {torch.equal(out, again)}"
        if timed:
            L = kc.shape[0]
            ms = device_ms(lambda i: fa.flash_decode_stacked(q, kc, vc, valid, slot, i % L, **sc),
                           calls=L)
            extra = _flash_bound_and_library("decode", q, kc, vc, valid, slot, sc)
            lib = ("none" if extra["library_ms"] is None
                   else f"{extra['library_ms'] * 1e3:.1f}us")
            text += (f" {ms * 1e3:.1f}us over the 32 layers, bound "
                     f"{extra['bound_ms'] * 1e3:.2f}us ({extra['bound_by']}), sdpa {lib}")
        cases.append(text)
        if not ok:
            failures.append(name + " " + text)

    for kv8 in (False, True):
        tag = "int8" if kv8 else "bf16"
        q, kc, vc, valid, slot = _kernel_case("decode", 1, 1, 32, 32, gen, L=32, slot0=2040)
        sc = {}
        if kv8:
            kc, vc, sc = _quantized_cache(kc, vc)
        one(f"{tag} B1 slot 2040 L32", q, kc, vc, valid, slot, 7, sc, timed=True)
        del q, kc, vc, sc
        q, kc, vc, valid, slot = _kernel_case("decode", 8, 1, 32, 32, gen)
        slot[3] = -1  # a parked row: nothing is visible
        sc = {}
        if kv8:
            kc, vc, sc = _quantized_cache(kc, vc)
        one(f"{tag} B8 ragged, slot -1 and a dead row", q, kc, vc, valid, slot, 1, sc,
            zero_rows=(3, 5))
        del q, kc, vc, sc
        q, kc, vc, valid, slot = _kernel_case("decode", 2, 1, 16, 16, gen, S=1024, hd=64)
        sc = {}
        if kv8:
            kc, vc, sc = _quantized_cache(kc, vc)
        one(f"{tag} hd64 B2 N16", q, kc, vc, valid, slot, 1, sc)
        del q, kc, vc, sc
    q, kc, vc, valid, slot = _kernel_case("decode", 2, 1, 32, 8, gen)
    one("f32 GQA B2", q.float(), kc.float(), vc.float(), valid, slot, 1, {})
    print(f"[3 kernels] B1 split-KV cases, tol atol=rtol={ATOL} (bf16), {F32_TOL} (f32): "
          + "; ".join(cases), flush=True)


def _b1_beam_cases(gen, prompt_len, worst, failures) -> dict:
    """B1 at the beam search's shape: B = BEAMS rows that share the chat's
    prompt (row 0's first ``prompt_len`` slots copied into every row, as the
    beams' fanned-out prefill leaves them; the 16 generated slots after it
    differ by row), all writing slot prompt + 16 of the 2048-slot, 32-layer cache,
    in bf16 (the summary row) and f32, each against its plain version, timed
    over the 32 layers in turn with its bound and
    ``scaled_dot_product_attention``."""
    L, S, slot_v = 32, 2048, prompt_len + 16
    row, cases = {}, []
    for dt in (torch.bfloat16, torch.float32):
        q = torch.randn(BEAMS, 1, 32, 128, generator=gen, device="cuda").to(dt)
        kc, vc = (torch.randn(L, BEAMS, 32, S, 128, generator=gen, device="cuda",
                              dtype=torch.bfloat16).to(dt) for _ in range(2))
        for c in (kc, vc):
            c[:, 1:, :, :prompt_len] = c[:, :1, :, :prompt_len]
        slot = torch.full((BEAMS,), slot_v, dtype=torch.int32, device="cuda")
        valid = (torch.arange(S, device="cuda") <= slot_v)[None].expand(BEAMS, -1).contiguous()
        out = fa.flash_decode_stacked(q, kc, vc, valid, slot, 7)
        torch.cuda.synchronize()
        ref = fa.flash_decode_stacked_ref(q.float(), kc.float(), vc.float(), valid, slot, 7)
        tol = ATOL if dt == torch.bfloat16 else F32_TOL
        err = (out.float() - ref).abs()
        ok = bool((err <= tol + tol * ref.abs()).all()) and bool(torch.isfinite(out).all())
        ms = device_ms(lambda i: fa.flash_decode_stacked(q, kc, vc, valid, slot, i % L), calls=L)
        plain_ms = device_ms(lambda i: fa.flash_decode_stacked_ref(q, kc, vc, valid, slot, i % L),
                             calls=L)
        extra = _flash_bound_and_library("decode", q, kc, vc, valid, slot, {},
                                         BF16_OPS_PER_S if dt == torch.bfloat16 else F32_OPS_PER_S)
        tag = "bf16" if dt == torch.bfloat16 else "f32"
        cases.append(f"{tag} B{BEAMS} slot {slot_v} L32 err={err.max().item():.2e} "
                     f"{ms * 1e3:.1f}us/plain {plain_ms * 1e3:.1f}us over the 32 layers, bound "
                     f"{extra['bound_ms'] * 1e3:.2f}us ({extra['bound_by']}), sdpa "
                     f"{extra['library_ms'] * 1e3:.1f}us")
        if dt == torch.bfloat16:
            worst["flash_decode_beam4"] = err.max().item()
            row = {"flash_decode_beam4": {"ms": ms, "plain_ms": plain_ms, **extra}}
        if not ok:
            failures.append("flash_decode_beam4 " + cases[-1])
        del q, kc, vc
    print(f"[3 kernels] B1 at the beam shape ({BEAMS} rows sharing a {prompt_len}-token prompt), "
          f"tol atol=rtol={ATOL} (bf16), {F32_TOL} (f32): " + "; ".join(cases), flush=True)
    return row


POOL_SLOTS = (300, 517, 1100, 2000)  # the running rows' write slots; a parked row after them


def _b1_pool_cases(gen, worst, failures) -> dict:
    """B1 at the contiguous pool's decode shape: 4 running rows writing
    slots ``POOL_SLOTS`` of the 2048-slot, 32-layer cache (left-padded
    prompts: each row's first 40 slots invalid) and one parked row (nothing
    valid: zeros out), bf16, against its plain version, timed over the 32
    layers in turn; its bound counts the valid slots each row reads, and
    ``scaled_dot_product_attention`` runs with the same mask over the
    longest row's window."""
    L, S, N, hd = 32, 2048, 32, 128
    B = len(POOL_SLOTS) + 1
    q = torch.randn(B, 1, N, hd, generator=gen, device="cuda").to(torch.bfloat16)
    kc, vc = (torch.randn(L, B, N, S, hd, generator=gen, device="cuda",
                          dtype=torch.bfloat16) for _ in range(2))
    slot = torch.tensor([*POOL_SLOTS, 700], dtype=torch.int32, device="cuda")
    ar = torch.arange(S, device="cuda")[None]
    valid = (ar >= 40) & (ar <= slot[:, None].long())
    valid[-1] = False  # the parked row: released, nothing valid
    valid = valid.contiguous()
    out = fa.flash_decode_stacked(q, kc, vc, valid, slot, 7)
    torch.cuda.synchronize()
    ref = fa.flash_decode_stacked_ref(q.float(), kc.float(), vc.float(), valid, slot, 7)
    err = (out.float() - ref).abs()
    ok = (bool((err <= ATOL + ATOL * ref.abs()).all()) and bool(torch.isfinite(out).all())
          and not bool(out[-1].any()))
    ms = device_ms(lambda i: fa.flash_decode_stacked(q, kc, vc, valid, slot, i % L), calls=L)
    plain_ms = device_ms(lambda i: fa.flash_decode_stacked_ref(q, kc, vc, valid, slot, i % L),
                         calls=L)
    n_kv = int(valid.sum())  # the valid slots the rows read, each <= its write slot
    b_ms, b_by = bound(2 * nbytes(q) + 2 * n_kv * N * hd * kc.element_size() + nbytes(valid),
                       4 * hd * N * n_kv)
    W = int(slot.max()) + 1
    mask = valid[:, None, None, :W]
    qt = q.transpose(1, 2)
    lib = device_ms(lambda i: F.scaled_dot_product_attention(
        qt, kc[i % L][:, :, :W], vc[i % L][:, :, :W], attn_mask=mask), calls=L)
    worst["flash_decode_pool"] = err.max().item()
    line = (f"bf16 B{B} (slots {list(POOL_SLOTS)} + a parked row) L32 S{S} "
            f"err={err.max().item():.2e} {ms * 1e3:.1f}us/plain {plain_ms * 1e3:.1f}us over "
            f"the 32 layers, bound {b_ms * 1e3:.2f}us ({b_by}, {n_kv} valid slots), sdpa "
            f"{lib * 1e3:.1f}us; the parked row's output zeros")
    if not ok:
        failures.append("flash_decode_pool " + line)
    print(f"[3 kernels] B1 at the contiguous pool's shape, tol atol=rtol={ATOL}: {line}",
          flush=True)
    del q, kc, vc
    return {"flash_decode_pool": {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                                  "bound_by": b_by, "library_ms": lib}}


def _b2u_check(q, k, v, valid, slot, causal, layout, sc, fn=None):
    """B2u (or ``fn``, a form of it) against its plain version in fp32 on the
    same bf16 (or int8) inputs: (max abs error, within tolerance and finite,
    the fully masked rows zero)."""
    kw = dict(causal=causal, kv_layout=layout, **sc)
    out = (fn or fa.flash_attention)(q, k, v, valid, slot, **kw)
    torch.cuda.synchronize()
    if sc:
        ref = fa.flash_attention_ref(q.float(), k, v, valid, slot, **kw)
    else:
        ref = fa.flash_attention_ref(q.float(), k.float(), v.float(), valid, slot, **kw)
    tol = ATOL if q.dtype == torch.bfloat16 else F32_TOL
    err = (out.float() - ref).abs()
    masked = ~valid.any(dim=1)
    ok = (bool((err <= tol + tol * ref.abs()).all()) and bool(torch.isfinite(out).all())
          and bool((out[masked] == 0).all()))
    return err.max().item(), ok


def _b2u_bound(q, k, valid, slot, causal, layout, sc):
    """B2u's least time: q, the K/V slots (and int8 scales) the queries can
    see, kv_valid and the output moved once; 4 hd operations a visible
    (query, slot) pair and head, counted on this run's mask."""
    B, Sq, N, hd = q.shape
    S = k.shape[1] if layout == "bsnh" else k.shape[2]
    Nkv = k.shape[2] if layout == "bsnh" else k.shape[1]
    j = torch.arange(S, device=q.device)
    if causal:
        q_slot = slot.long()[:, None] + torch.arange(Sq, device=q.device)[None, :]
        seen = valid[:, None, :] & (j[None, None, :] <= q_slot[:, :, None])
        n_kv = int(torch.clamp(slot.long() + Sq, max=S).sum())
    else:
        seen = valid[:, None, :].expand(B, Sq, S)
        n_kv = B * S
    per_slot = 2 * Nkv * hd * k.element_size() + (2 * Nkv * 4 if sc else 0)
    moved = 2 * nbytes(q) + n_kv * per_slot + nbytes(valid)
    rate = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else F32_OPS_PER_S
    return bound(moved, 4 * hd * N * int(seen.sum()), rate)


def _b2u_cases(gen, worst, failures):
    """B2u against its plain version, with its bound, the plain version's
    time and ``scaled_dot_product_attention``'s at the same shape: the ViT
    (257 tokens, 16 heads x 64, causal off; B = 1 and 8, bf16 and f32), the
    ViT at 448 px (1025 tokens), the resampler (64 queries over 321 slots)
    and the mesh form of cached attention (bnsh, causal, hd 128, B = 2, Sq
    512 on per-row slots 100 / 1000 with invalid leading slots, S 2048, bf16
    and int8 K/V), plus a fully masked row.  Then one op-level pass of
    ``cached_attention(layer_index=None)`` over 32 layers of the int8 mesh
    form with the launch counter from zero.  -> (main-path entries: the ViT
    at B = 1 bf16 and the int8 mesh form, the pass's launches)."""
    dev = "cuda"

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    main, cases, launches = {}, [], {}
    shapes = [("ViT", 1, 257, 257, torch.bfloat16), ("ViT", 8, 257, 257, torch.bfloat16),
              ("ViT", 1, 257, 257, torch.float32), ("ViT", 8, 257, 257, torch.float32),
              ("ViT 448px", 1, 1025, 1025, torch.bfloat16),
              ("resampler", 1, 64, 321, torch.bfloat16), ("resampler", 8, 64, 321,
                                                          torch.bfloat16)]
    for label, B, Sq, S, dtype in shapes:
        q, k, v = rnd(B, Sq, 16, 64, dtype=dtype), rnd(B, S, 16, 64, dtype=dtype), \
            rnd(B, S, 16, 64, dtype=dtype)
        valid = torch.ones(B, S, dtype=torch.bool, device=dev)
        err, ok = _b2u_check(q, k, v, valid, 0, False, "bsnh", {})
        worst["flash_full"] = max(worst["flash_full"], err)
        ms = device_ms(lambda i: fa.flash_attention(q, k, v, valid, 0, causal=False))
        plain_ms = device_ms(lambda i: fa.flash_attention_ref(q, k, v, valid, 0, causal=False),
                             calls=2)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        lib_ms = device_ms(lambda i: F.scaled_dot_product_attention(qt, kt, vt))
        b_ms, b_by = _b2u_bound(q, k, valid, None, False, "bsnh", {})
        cases.append(f"{label} B{B} {str(dtype)[6:]} err={err:.2e} {ms * 1e3:.1f}us/plain "
                     f"{plain_ms * 1e3:.1f}us/sdpa {lib_ms * 1e3:.1f}us, bound "
                     f"{b_ms * 1e3:.2f}us ({b_by})")
        if not ok:
            failures.append("flash_full " + cases[-1])
        if label == "ViT" and B == 1 and dtype == torch.bfloat16:
            main["flash_full"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                                  "bound_by": b_by, "library_ms": lib_ms}
        del q, k, v
    # int8 K/V at the ViT's token counts (hd 64, bsnh, causal off): no path of
    # the model runs it; the template's int8 conversion at hd 64
    for tokens in (257, 1025):
        q, k, v = rnd(2, tokens, 16, 64), rnd(2, tokens, 16, 64), rnd(2, tokens, 16, 64)
        (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
        valid = torch.ones(2, tokens, dtype=torch.bool, device=dev)
        valid[1, 5:40] = False
        sc = {"k_scale": ks, "v_scale": vs}
        err, ok = _b2u_check(q, kq, vq, valid, 0, False, "bsnh", sc)
        worst["flash_full_kv8"] = max(worst["flash_full_kv8"], err)
        ms = device_ms(lambda i: fa.flash_attention(q, kq, vq, valid, 0, causal=False, **sc))
        cases.append(f"int8 K/V hd64 bsnh B2 {tokens} tokens err={err:.2e} {ms * 1e3:.1f}us")
        if not ok:
            failures.append("flash_full_kv8 " + cases[-1])
        del q, k, v, kq, vq
    # the mesh form: bnsh K/V of one layer, causal from per-row slots
    L, B, Sq, S, N = 32, 2, 512, 2048, 32
    slot = torch.tensor([100, 1000], dtype=torch.int32, device=dev)
    valid = torch.arange(S, device=dev)[None, :] < slot[:, None].long() + Sq
    valid[0, :7], valid[1, :300] = False, False
    q, kc, vc = rnd(B, Sq, N, 128), rnd(L, B, N, S, 128), rnd(L, B, N, S, 128)
    for kv8 in (False, True):
        name = "flash_full_kv8" if kv8 else "flash_full"
        k, v, sc = kc[7], vc[7], {}
        if kv8:
            kq, vq, scales = _quantized_cache(kc, vc)
            k, v = kq[7], vq[7]
            sc = {"k_scale": scales["k_scale"][7], "v_scale": scales["v_scale"][7]}
        err, ok = _b2u_check(q, k, v, valid, slot, True, "bnsh", sc)
        dead = valid.clone()
        dead[1] = False  # a fully masked row
        err2, ok2 = _b2u_check(q, k, v, dead, slot, True, "bnsh", sc)
        worst[name] = max(worst[name], err, err2)
        ms = device_ms(lambda i: fa.flash_attention(q, k, v, valid, slot, kv_layout="bnsh", **sc))
        plain_ms = device_ms(
            lambda i: fa.flash_attention_ref(q, k, v, valid, slot, kv_layout="bnsh", **sc),
            calls=2)
        b_ms, b_by = _b2u_bound(q, k, valid, slot, True, "bnsh", sc)
        lib_ms = None
        if not kv8:  # the same function through a boolean mask (SDPA takes no int8 K/V)
            q_slot = slot.long()[:, None] + torch.arange(Sq, device=dev)[None, :]
            mask = (valid[:, None, :] & (torch.arange(S, device=dev)[None, None, :]
                                         <= q_slot[:, :, None]))[:, None]
            qt = q.transpose(1, 2)
            lib_ms = device_ms(lambda i: F.scaled_dot_product_attention(qt, k, v,
                                                                        attn_mask=mask))
        lib = "none" if lib_ms is None else f"{lib_ms * 1e3:.1f}us"
        cases.append(f"mesh form {'int8' if kv8 else 'bf16'} (bnsh causal hd128 B2 Sq512 slots "
                     f"100/1000 S2048) err={err:.2e}, fully masked row err={err2:.2e} "
                     f"{ms * 1e3:.1f}us/plain {plain_ms * 1e3:.1f}us/sdpa {lib}, bound "
                     f"{b_ms * 1e3:.2f}us ({b_by})")
        if not (ok and ok2):
            failures.append(name + " " + cases[-1])
        if kv8:
            main[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                          "library_ms": None}
            torch.cuda.synchronize()
            fa.reset_launch_counts()
            for layer in range(L):
                cached_attention(q, kq[layer], vq[layer], valid, slot,
                                 k_scale=scales["k_scale"][layer],
                                 v_scale=scales["v_scale"][layer])
            torch.cuda.synchronize()
            launches[name] = fa.LAUNCHES[name]
            del kq, vq, scales
    del q, kc, vc
    torch.cuda.empty_cache()
    print(f"[3 kernels] B2u flash attention over unstacked K/V (causal off unless stated, "
          f"all slots valid for the vision shapes), tol atol=rtol={ATOL} (bf16), {F32_TOL} "
          f"(f32); bound at {BF16_OPS_PER_S / 1e12:.0f} TFLOP/s for bf16 and "
          f"{F32_OPS_PER_S / 1e12:.0f} for f32 inputs: " + "; ".join(cases)
          + f"; op-level pass launches {launches}", flush=True)
    return main, launches


def _sm_count() -> int:
    return i4._sm_count(torch.device("cuda"))


def _b3_form(T: int, in_dim: int, out: int) -> str:
    """The launch counter of the form B3's wrapper picks for T tokens of an
    (in_dim, out) weight (gs 128)."""
    return "int4_matmul_" + ("decode" if i4.decode_form(T, in_dim, out, _sm_count())
                             else "prefill")


def _b3_pass_counts(T: int, layers: int, head_tokens: int = None) -> dict:
    """B3's launches, by form, of one pass of the 7B text tower over T tokens:
    7 matmuls a layer, then the head on ``head_tokens`` (default T)."""
    counts = {"int4_matmul_decode": 0, "int4_matmul_prefill": 0}
    for in_dim, out in LAYER_SHAPES.values():
        counts[_b3_form(T, in_dim, out)] += layers
    counts[_b3_form(T if head_tokens is None else head_tokens, *HEAD_SHAPE)] += 1
    return counts


def _parent_decode_form(T: int, in_dim: int, out: int, sms: int) -> bool:
    """The parent commit's ``decode_form`` (in_dim cancelled out of it): the
    decode form while its 8-token slices cost less than the prefill form's
    waves at T."""
    tt = 1
    while tt < min(T, 8):
        tt *= 2
    slices = -(-T // tt) * PARENT_DECODE_SLICE_COST[tt]
    rows = i4.PREFILL_TILES[i4.prefill_tiling(T, out, sms)]
    waves = -(-(-(-out // 128) * -(-T // rows)) // sms)
    if out % 16:
        waves *= i4._UNALIGNED_PREFILL_COST
    return slices * out < PARENT_DECODE_COLUMNS_PER_SM * sms * waves


@contextlib.contextmanager
def _parent_b3_forms():
    """B3's form chosen as the parent commit chose it (``_parent_decode_form``;
    the kernels are this tree's), for a timing beside the wrapper's."""
    keep = i4.decode_form
    i4.decode_form = _parent_decode_form
    try:
        yield
    finally:
        i4.decode_form = keep


def _profiled_device_ms(fn, n: int = 4) -> float:
    """Device time of one ``fn()`` under torch.profiler, over ``n`` calls."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / n / 1e3


def _b3_weight(gen, in_dim, out):
    """A random bf16 (in, out) weight quantized on the card: (carrier, scale)."""
    w = (torch.randn(in_dim, out, generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
    wq = quantize_grouped(w, group=128)
    return wq["q"], wq["scale"]


def _b3_check(x, q, s, out_dtype, form=None):
    """B3 (the wrapper's form, or ``form``) against its plain version in fp32
    on the same bf16 x and carrier: (max abs error, within tolerance and
    finite)."""
    y = i4._launch(x, q, s, out_dtype, form=form)
    torch.cuda.synchronize()
    ref = i4.int4_matmul_ref(x.float(), q, s)
    err = (y.float() - ref).abs()
    tol = B3_TOL * ref.abs().max() + B3_TOL * ref.abs()
    ok = bool((err <= tol).all()) and bool(torch.isfinite(y).all())
    return err.max().item(), ok


def _b3_cases(gen, prompt_bucket, worst, failures):
    """B3 at the 7B shapes: each (in, out) alone at 1, 8 and 512 tokens
    (layers write bf16, the head f32, as on the main path); one decoder
    layer's seven matmuls in turn (99.5 MB of carrier, more than the L2) at
    the main path's token counts, 1 and the prompt's bucket; and the decode
    and prefill forms side by side on every shape at ``CROSSOVER_TOKENS``,
    with the form ``i4.decode_form`` picks."""
    cases, main = [], {}
    weights = {name: _b3_weight(gen, *shape) for name, shape in LAYER_SHAPES.items()}
    weights["lm_head"] = _b3_weight(gen, *HEAD_SHAPE)
    shapes = {}  # (in, out) -> (carrier, scale, out dtype), each shape once
    for name, (q, s) in weights.items():
        out_dtype = torch.float32 if name == "lm_head" else torch.bfloat16
        shapes.setdefault((2 * q.shape[0] * q.shape[1], q.shape[2]), (q, s, out_dtype))
    for (in_dim, out), (q, s, out_dtype) in shapes.items():
        for T in (1, 8, 512):
            x = torch.randn(T, in_dim, generator=gen, device="cuda").to(torch.bfloat16)
            form = _b3_form(T, in_dim, out)
            err, ok = _b3_check(x, q, s, out_dtype)
            worst[form] = max(worst[form], err)
            ms = device_ms(lambda i: i4.int4_matmul(x, q, s, out_dtype=out_dtype))
            plain_ms = device_ms(lambda i: i4.int4_matmul_ref(x, q, s, out_dtype=out_dtype),
                                 calls=2)
            cases.append(f"({in_dim},{out})xT{T} {form[12:]} err={err:.2e} {ms * 1e3:.1f}us/"
                         f"plain {plain_ms * 1e3:.1f}us")
            if not ok:
                failures.append(form + " " + cases[-1])
    layer = [weights[n] for n in LAYER_SHAPES]
    per_layer = []
    for form, T in (("int4_matmul_decode", 1), ("int4_matmul_prefill", prompt_bucket)):
        xs = {k: torch.randn(T, k, generator=gen, device="cuda").to(torch.bfloat16)
              for k in (4096, 11008)}

        def run(fn, i):
            for q, s in layer:
                fn(xs[2 * q.shape[0] * q.shape[1]], q, s)

        ms = device_ms(lambda i: run(i4.int4_matmul, i), calls=2) / len(layer)
        plain_ms = device_ms(lambda i: run(i4.int4_matmul_ref, i), calls=2) / len(layer)
        # the yardstick: a bf16 torch.matmul of the same shapes on the
        # dequantized weights (the same function)
        dense = [dequantize_grouped(q, s, torch.bfloat16) for q, s in layer]
        lib_ms = device_ms(lambda i: [xs[w.shape[0]] @ w for w in dense], calls=2) / len(layer)
        del dense
        moved = sum(nbytes(q, s) + T * 2 * (2 * q.shape[0] * q.shape[1] + q.shape[2])
                    for q, s in layer) / len(layer)
        ops = sum(2 * T * 2 * q.shape[0] * q.shape[1] * q.shape[2] for q, _ in layer) / len(layer)
        b_ms, b_by = bound(moved, ops)
        if any(_b3_form(T, *shape) != form for shape in LAYER_SHAPES.values()):
            failures.append(f"the wrapper does not pick {form} for every layer shape at T{T}")
        main[form] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": lib_ms}
        tiling = (f", prefill tiling {i4.prefill_tiling(T, 4096, _sm_count())} / "
                  f"{i4.prefill_tiling(T, 11008, _sm_count())} (out 4096 / 11008)"
                  if form == "int4_matmul_prefill" else "")
        per_layer.append(f"T{T}: {ms * 1e3:.1f}us/plain {plain_ms * 1e3:.1f}us/bf16 matmul "
                         f"{lib_ms * 1e3:.1f}us per call, bound {b_ms * 1e3:.2f}us ({b_by}, "
                         f"{100 * b_ms / ms:.1f} % of it){tiling}")
    cross, slower = [], []
    for (in_dim, out), (q, s, out_dtype) in shapes.items():
        cells = []
        for T in CROSSOVER_TOKENS:
            x = torch.randn(T, in_dim, generator=gen, device="cuda").to(torch.bfloat16)
            t = {}
            for form in i4.FORMS:
                err, ok = _b3_check(x, q, s, out_dtype, form=form)
                t[form] = device_ms(lambda i: i4._launch(x, q, s, out_dtype, form=form))
                if not ok:
                    failures.append(f"int4_matmul_{form} ({in_dim},{out}) T{T} err={err:.2e}")
            pick = _b3_form(T, in_dim, out)[12:]
            cells.append(f"T{T} {t['decode'] * 1e3:.1f}/{t['prefill'] * 1e3:.1f} {pick[0]}")
            if t[pick] > 1.1 * min(t.values()):
                slower.append(f"({in_dim},{out}) T{T} {pick}")
        cross.append(f"({in_dim},{out}) " + ", ".join(cells))
    line = (f"[3 kernels] B3 int4 (gs 128), tol {B3_TOL}*max|ref| + {B3_TOL}*|ref|, the form "
            f"from i4.decode_form: " + "; ".join(cases)
            + "; one decoder layer's 7 matmuls in turn: " + "; ".join(per_layer)
            + "; decode/prefill us and the form picked: " + "; ".join(cross)
            + f"; picked the form over 10 % slower at {slower or 'no point'}")
    return main, line


def phase_slice(smi: str, cfg, tokenizer) -> dict:
    L = cfg.text_config.num_hidden_layers
    model, setup_s = _random_model(cfg)
    bundle = api.VisualCLA(model, cfg, tokenizer, ImageProcessor(image_size=224),
                           max_seq_len=2048)
    image = random_image(SEED)
    greedy = SamplingConfig.greedy(max_new_tokens=32)

    # the full-width prefill against the same model with plain attention;
    # bf16 rounding through 32 random layers reaches a few % of the logit
    # scale, so bf16 is held loosely (gross errors) and fp32 tightly below
    enc = encoding_text([], PROMPT, bundle.num_patch, tokenizer)
    pv = bundle.image_processor(image)["pixel_values"]
    eng = bundle.engine
    pos = img_marker_positions(enc["input_ids"], tokenizer.img_start_token_id)
    logit_diff, logit_scale = _loose_logits_check(eng, enc["input_ids"], pv, pos, "bf16")
    # the first chat captures the start and the decode step: its TTFT holds
    # the start's capture
    t_first = time.perf_counter()
    for _ in api.chat_in_stream(bundle, image, PROMPT, [], greedy, verbose=False):
        ttft_first = time.perf_counter() - t_first
        break
    torch.cuda.synchronize()

    # the main path's run: one greedy chat, its launches counted from zero
    response, chat_counts, passes = _counted_chat(bundle, image, greedy)
    # the same prompt through generate for its ids: one prefill, then the
    # captured decode steps, each through all L layers (a step gated off
    # after the last token still runs them)
    ids = bundle.generate(enc["input_ids"], pixel_values=pv, generation_config=greedy)[0]
    n_gen = len(ids)
    if passes["decode_passes"] < n_gen - 1:
        raise RuntimeError(f"{passes} decode passes for {n_gen} tokens")
    _check_counts(chat_counts, {"flash_prefill": L, "flash_decode": L * passes["decode_passes"]})
    loop = _captured_vs_eager(eng, enc["input_ids"], pv, pos, greedy, "bf16 greedy")
    # sampled (the default config, 48 tokens): the captured philox draws are
    # the eager ones
    sampled48 = SamplingConfig(max_new_tokens=48)
    s_cap = bundle.generate(enc["input_ids"], pixel_values=pv, generation_config=sampled48,
                            seed=SEED)
    with graphs_mod.eager():
        s_eag = bundle.generate(enc["input_ids"], pixel_values=pv, generation_config=sampled48,
                                seed=SEED)
    if s_cap.tolist() != s_eag.tolist():
        raise RuntimeError(f"sampled generate: captured {s_cap.tolist()} != eager "
                           f"{s_eag.tolist()}")

    ttft, rate = _streams(bundle, image, greedy, response, enc["input_ids"], pv, ids)
    start = _start_times(bundle, enc["input_ids"], pv, pos, greedy)
    # four decode steps between host reads: the same text at the end
    chunked = ""
    for chunked, _ in api.chat_in_stream(bundle, image, PROMPT, [], greedy, verbose=False,
                                         chunk_size=4):
        pass
    if chunked.lstrip(" ") != response.lstrip(" "):
        raise RuntimeError(f"chat_in_stream(chunk_size=4) {chunked!r} != chat {response!r}")
    # speculative: one prefill, then one verify chunk of K+1 tokens a pass
    spec = _spec_chat(bundle, image, lambda p: {"flash_prefill": L * (1 + p)})

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
    print(f"[4 slice] VisualCLA-7B bf16 full width (ViT-L/14 24L, resampler 6L/64q, "
          f"LLaMA-7B 32L vocab {cfg.text_config.vocab_size}), random weights seed {SEED}, "
          f"built in {setup_s:.1f} s; prompt {len(enc['input_ids'][0])} tokens (bucket "
          f"{eng.bucket_len(len(enc['input_ids'][0]))}); prefill logits kernels vs plain max diff "
          f"bf16 {logit_diff:.3e}, fp32 {logit_diff32:.3e} (scale {logit_scale:.2f}); greedy chat {n_gen} tokens, "
          f"stream ids equal, chat_in_stream(chunk_size=4) the same text; B=2 vs single-row prefill logits max diff bf16 {b2_diff:.3e}, "
          f"fp32 {b2_diff32:.3e}; fp32 B=2 rows equal their single-row runs over "
          f"{greedy.max_new_tokens} tokens; "
          f"sampled chat "
          f"{sampled_s:.2f} s; sampled generate (48 tokens, seed {SEED}) captured == eager; "
          f"greedy chat launches {chat_counts} ({passes['decode_passes']} decode passes); "
          f"TTFT {ttft * 1e3:.1f} ms warm (median of 3, "
          f"preprocess + encode + prefill + first token), {ttft_first * 1e3:.1f} ms for the "
          f"first chat (its captures included); {_start_line(start)}; B=1 decode "
          f"{rate:.1f} tok/s (chat_in_stream, one captured step a token); {_loop_line(loop)}; "
          f"{_spec_line(spec)}; card {smi}", flush=True)
    return {"launches": chat_counts, "ttft_ms": ttft * 1e3, "decode_tok_s": rate,
            "ttft_first_ms": ttft_first * 1e3, "start": start,
            "spec": spec, "bundle": bundle, "ids": ids, "loop": loop}


def phase_concurrency(smi: str, cfg, tokenizer, bundle) -> dict:
    """Two requests at once on phase 4's engine: two greedy streams of one
    shape that meet at the prefill (each claims its own workspace first),
    then a stream replaying its graphs while a B=3 generate captures new
    ones; each call's ids equal its sequential run's."""
    eng = bundle.engine
    greedy = SamplingConfig.greedy(max_new_tokens=16)
    prompts = []
    for k in range(2):
        ids, pv, img = _chat_request(bundle, tokenizer, random_image(SEED + 60 + k))
        prompts.append((ids[None], pv, np.array([img])))
    want = [eng.generate(*p, greedy)[0].tolist() for p in prompts]
    meet = threading.Barrier(2)
    orig = Engine.stage_prompt

    def staged(self, *a, **k):
        try:
            meet.wait(timeout=30)
        except threading.BrokenBarrierError:
            pass
        return orig(self, *a, **k)

    out = [None] * 2
    claims0 = len(eng._workspaces)
    Engine.stage_prompt = staged
    try:
        _run_all([lambda k=k: out.__setitem__(k, [int(t[0]) for t in eng.stream(
            *prompts[k], greedy, chunk_size=4)]) for k in range(2)])
    finally:
        Engine.stage_prompt = orig
    if out != want:
        raise RuntimeError(f"overlapping streams {out} != their sequential ids {want}")
    # a stream replaying while another thread captures a B=3 start and
    # decode step (a shape no earlier phase ran)
    rows = [0, 1, 0]
    batch = np.concatenate([prompts[k][0] for k in rows])
    pv2 = np.concatenate([prompts[k][1] for k in rows])
    pos2 = np.concatenate([prompts[k][2] for k in rows])
    captures0 = eng.graphs.captures
    both = [None, None]
    _run_all([lambda: both.__setitem__(0, [int(t[0]) for t in eng.stream(*prompts[0], greedy)]),
              lambda: both.__setitem__(1, eng.generate(batch, pv2, pos2, greedy).tolist())])
    want2 = eng.generate(batch, pv2, pos2, greedy).tolist()
    if both[0] != want[0] or both[1] != want2 or eng.graphs.captures == captures0:
        raise RuntimeError(f"a stream beside a capture: {both} != {[want[0], want2]}, "
                           f"{eng.graphs.captures - captures0} captures")
    busy = [ws.key for ws in eng._workspaces.values() if ws.busy]
    if busy:
        raise RuntimeError(f"workspaces left claimed: {busy}")
    print(f"[4f concurrency] phase 4's engine: two greedy streams of one shape meeting at the "
          f"prefill ({claims0} cached workspace(s) before; the second call claims a private "
          f"one) give their sequential ids ({len(want[0])} and {len(want[1])} tokens); a "
          f"stream replaying beside a B=3 generate that captured "
          f"{eng.graphs.captures - captures0} new graphs gives its sequential ids, and so does "
          f"the B=3 call; no workspace left claimed; card {smi}", flush=True)
    return {"streams": out}


def _callback_run(predict, image, sliders):
    """One submit of the demo's callback: -> (its last (chatbot, history),
    the seconds from the call to each yield)."""
    t0 = time.perf_counter()
    stamps, last = [], None
    for last in predict(PROMPT, image, None, [], *sliders, [], "Upload"):
        stamps.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return last, stamps


def _apps_callback(bundle, image, L) -> dict:
    """(a) The Gradio callback on phase 4's model, streamed and blocking,
    with the sliders at 32 tokens, top-k 1 (a deterministic sampled
    config), top-p .9, temperature .5: launches counted from zero over the
    streamed run (B2 once a layer a prefill pass, B1 once a layer a decode
    pass, nothing else), both runs' answer equal (up to the stream's
    leading-space fixup, as in ``chat_in_stream``) and equal to ``chat``'s
    with the same config and seed; without an image the error message and
    no launch."""
    sliders = (32, 0.9, 1, 0.5)  # max_new_tokens, top_p, top_k, temperature
    gc = dataclasses.replace(api.DEFAULT_GENERATION_CONFIG, max_new_tokens=32, top_p=0.9,
                             top_k=1, temperature=0.5)
    stream = gradio_demo.make_predict(bundle)
    blocking = gradio_demo.make_predict(bundle, no_stream=True)
    eng = bundle.engine
    _callback_run(stream, image, sliders)  # warm-up: this config's captures
    passes0 = dict(eng.counts)
    _reset_counters()
    (s_bot, s_hist), stamps = _callback_run(stream, image, sliders)
    counts = _counters()
    passes = {k: n - passes0[k] for k, n in eng.counts.items()}
    _check_counts(counts, {"flash_prefill": L * passes["prefill_passes"],
                           "flash_decode": L * passes["decode_passes"]})
    (b_bot, b_hist), b_stamps = _callback_run(blocking, image, sliders)
    if len(b_stamps) != 1:
        raise RuntimeError(f"the blocking callback yielded {len(b_stamps)} times")
    s_text, b_text = s_hist[-1]["value"], b_hist[-1]["value"]
    question = gradio_demo.parse_text(PROMPT)
    if (s_hist[:-1] != b_hist[:-1] or s_text.lstrip(" ") != b_text.lstrip(" ")
            or s_bot != [(question, gradio_demo.convert_markdown(s_text))]
            or b_bot != [(question, gradio_demo.convert_markdown(b_text))]):
        raise RuntimeError(f"callback: streamed {s_bot} / {s_hist} != blocking {b_bot} / "
                           f"{b_hist}")
    want, _ = api.chat(bundle, image, PROMPT, [], gc, verbose=False)
    if b_text != want:
        raise RuntimeError(f"callback answer {b_text!r} != chat's {want!r}")
    _reset_counters()
    empty = list(blocking(PROMPT, None, None, [("q", "a")], *sliders, [], "Upload"))
    if empty != [([(PROMPT, gradio_demo.EMPTY_IMAGE)], [])] or any(_counters().values()):
        raise RuntimeError(f"no-image callback yielded {empty}, launched {_counters()}")
    n = len(stamps)
    return {"ttft_ms": stamps[0] * 1e3, "tok_s": (n - 1) / (stamps[-1] - stamps[0]),
            "tokens": n, "launches": {k: v for k, v in counts.items() if v},
            "blocking_s": b_stamps[0]}


def _apps_plugin(bundle, cfg) -> dict:
    """(b) The webui plugin over a ``VisionPipeline`` of phase 4's towers,
    a stand-in webui ``shared`` on the card in bf16, 2 seeded images: the
    (128, 4096) bf16 output on the card, bitwise the JAX contract's host
    round trip (``VisionPipeline.embed_images``: f32 numpy, cast back) and
    the model's own ``encode_image`` of the same pixels; row block 0 against
    the chat's encode of that image alone (B=1: GEMMs of another shape, so
    within EMBED_REL_TOL of the largest value, as bf16 rounding through 30
    layers allows).  Warm host and device ms (CUDA events around the call,
    host gaps included), medians of 5, for the plugin's call, the round
    trip and the host preprocessing both start with."""
    class Shared:  # webui's modules.shared, as much as the plugin reads
        class model:
            device = torch.device("cuda")
            dtype = torch.bfloat16

    from PIL import Image

    images = [Image.fromarray(random_image(SEED + 70 + k)) for k in range(2)]
    pipe = VisionPipeline(bundle.model, cfg)
    plugin = webui_plugin.VisualCLA_7B_Torch_Pipeline.__new__(
        webui_plugin.VisualCLA_7B_Torch_Pipeline)
    plugin.pipeline = pipe
    keep = webui_plugin._shared
    webui_plugin._shared = lambda: Shared
    try:
        got = plugin.embed_images(images)
        H = cfg.text_config.hidden_size
        T = cfg.num_image_tokens
        if (tuple(got.shape) != (2 * T, H) or got.dtype != torch.bfloat16
                or got.device.type != "cuda"):
            raise RuntimeError(f"plugin output {tuple(got.shape)} {got.dtype} {got.device}")

        def round_trip():
            return torch.from_numpy(pipe.embed_images(images)).reshape(-1, H).to(
                "cuda", torch.bfloat16)

        if not torch.equal(got, round_trip()):
            raise RuntimeError("plugin output differs from the host round trip")
        px = torch.from_numpy(pipe.image_processor(images)["pixel_values"]).to(
            "cuda", torch.bfloat16)
        with torch.no_grad():
            own = encode_image(bundle.model, cfg, px).reshape(-1, H)
            alone = encode_image(bundle.model, cfg, px[:1])[0]
        if not torch.equal(got, own):
            raise RuntimeError("plugin output differs from encode_image of the same pixels")
        diff0 = (got[:T].float() - alone.float()).abs().max().item()
        rel0 = _rel(got[:T], alone)
        if rel0 > EMBED_REL_TOL:
            raise RuntimeError(f"row block 0 differs from the B=1 encode by {diff0} "
                               f"({rel0:.3e} of its largest value)")
        times = {name: _host_and_event_ms(fn) for name, fn in
                 (("plugin", lambda: plugin.embed_images(images)), ("round_trip", round_trip),
                  ("preprocess", lambda: pipe.image_processor(images)))}
    finally:
        webui_plugin._shared = keep
    return {"block0_diff": diff0, "block0_rel": rel0, **times}


def _host_and_event_ms(fn, n: int = 5) -> dict:
    """Warm medians of ``fn()``: host ms (synchronized) and device ms (CUDA
    events around the call on the current stream)."""
    fn()
    host, dev = [], []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        dev.append(start.elapsed_time(end))
    return {"host_ms": statistics.median(host), "device_ms": statistics.median(dev)}


def _apps_profiling(bundle, tokenizer, image) -> dict:
    """(c) ``utils.profiling`` on phase 4's engine: 3 greedy ``generate``s
    of 32 tokens (the timer's summary ``prefill`` x3 and ``decode`` x3;
    ``GLOBAL_COUNTERS`` up by 3 x gen_len tokens and 3 requests), a
    speculative ``generate`` (``spec_chunks`` up by its chunks), and
    ``trace`` around one greedy ``generate``, whose file must name B1's and
    B2's CUDA symbols."""
    eng = bundle.engine
    enc = encoding_text([], PROMPT, bundle.num_patch, tokenizer)
    ids = enc["input_ids"]
    pv = bundle.image_processor(image)["pixel_values"]
    pos = img_marker_positions(ids, tokenizer.img_start_token_id)
    greedy = SamplingConfig.greedy(max_new_tokens=32)
    eng.generate(ids, pv, pos, greedy)  # warm
    eng.timer.reset()
    c0 = profiling.GLOBAL_COUNTERS.snapshot()
    outs = [eng.generate(ids, pv, pos, greedy) for _ in range(3)]
    summary = eng.timer.summary()
    c1 = profiling.GLOBAL_COUNTERS.snapshot()
    delta = {k: c1.get(k, 0) - c0.get(k, 0) for k in ("generated_tokens", "requests")}
    gen_len = outs[0].shape[1]
    if ({k: v["count"] for k, v in summary.items()} != {"prefill": 3, "decode": 3}
            or delta != {"generated_tokens": 3 * gen_len, "requests": 3}):
        raise RuntimeError(f"timer {summary}, counters moved by {delta} for 3 x {gen_len}")
    dec = bundle.speculative_decoder()
    spec_ids = dec.generate(ids, pv, pos, greedy)
    c2 = profiling.GLOBAL_COUNTERS.snapshot()
    chunks = dec.last_stats["chunks"]
    spec_delta = {k: c2.get(k, 0) - c1.get(k, 0)
                  for k in ("generated_tokens", "requests", "spec_chunks")}
    want = {"generated_tokens": spec_ids.shape[1], "requests": 1, "spec_chunks": chunks}
    if spec_delta != want or eng.timer.summary()["decode"]["count"] != 4:
        raise RuntimeError(f"speculative generate moved the counters by {spec_delta}, "
                           f"expected {want}")
    with tempfile.TemporaryDirectory() as d:
        with profiling.trace(d):
            eng.generate(ids, pv, pos, greedy)
        path = os.path.join(d, "trace.json")
        trace_bytes = os.path.getsize(path)
        with open(path) as f:
            text = f.read()
    symbols = {"B1": "flash_decode_split_kernel", "B2": "flash_attention_wgmma_kernel"}
    missing = [k for k, s in symbols.items() if s not in text]
    if missing:
        raise RuntimeError(f"the trace names no {missing} kernel ({trace_bytes} bytes)")
    return {"prefill_p50_ms": summary["prefill"]["p50_ms"],
            "decode_p50_ms": summary["decode"]["p50_ms"], "gen_len": gen_len,
            "spec_chunks": chunks, "trace_mb": trace_bytes / 2**20,
            "b1_events": text.count(symbols["B1"]), "b2_events": text.count(symbols["B2"])}


def phase_apps(smi: str, cfg, tokenizer, bundle, sl) -> dict:
    """The reference's front ends on phase 4's bf16 model: (a) the Gradio
    demo's callback, (b) the webui plugin's ``embed_images``, (c) the
    profiling utilities (see the helpers).  The parity harness is not run
    here: it needs transformers and the reference's own checkout and
    checkpoint, which this machine lacks; the CPU tests hold it."""
    L = cfg.text_config.num_hidden_layers
    image = random_image(SEED)
    cb = _apps_callback(bundle, image, L)
    plug = _apps_plugin(bundle, cfg)
    prof = _apps_profiling(bundle, tokenizer, image)
    loop, start = sl["loop"], sl["start"]
    print(f"[12 apps] (a) Gradio callback (sliders 32 tokens, top-k 1, top-p .9, temperature "
          f".5), rendered with convert_markdown: streamed and blocking equal, equal to chat's answer; "
          f"launches {cb['launches']}; TTFT {cb['ttft_ms']:.1f} ms (first yield), "
          f"{cb['tok_s']:.1f} tok/s over {cb['tokens']} yields, blocking "
          f"{cb['blocking_s'] * 1e3:.1f} ms (phase 4: TTFT {sl['ttft_ms']:.1f} ms, "
          f"{sl['decode_tok_s']:.1f} tok/s); no-image call: the message, no launch; "
          f"(b) webui plugin on 2 seeded PIL images: (128, 4096) bf16 on the card, bitwise "
          f"the host round trip and encode_image of the same pixels, row block 0 vs the B=1 "
          f"encode max diff {plug['block0_diff']:.3e} ({plug['block0_rel']:.3e} of the "
          f"largest value); plugin {plug['plugin']['host_ms']:.2f} "
          f"ms host / {plug['plugin']['device_ms']:.2f} ms device vs round trip "
          f"{plug['round_trip']['host_ms']:.2f} / {plug['round_trip']['device_ms']:.2f} "
          f"(warm, medians of 5; CUDA events around each call: host gaps included), both "
          f"starting with {plug['preprocess']['host_ms']:.2f} ms of host preprocessing; (c) profiling: 3 greedy generates of {prof['gen_len']} "
          f"tokens, timer prefill p50 {prof['prefill_p50_ms']:.2f} ms, decode p50 "
          f"{prof['decode_p50_ms']:.2f} ms (host, synced; phase 4: captured start "
          f"{start['warm_device_ms']:.2f} ms device, decode {loop['step_ms']:.3f} ms a step "
          f"x {prof['gen_len'] - 1} = {loop['step_ms'] * (prof['gen_len'] - 1):.2f} ms, CUDA "
          f"events), counters exact, speculative generate {prof['spec_chunks']} spec_chunks; "
          f"trace {prof['trace_mb']:.2f} MB naming B1 {prof['b1_events']}x and B2 "
          f"{prof['b2_events']}x; card {smi}", flush=True)
    return {"callback": cb, "plugin": plug, "profiling": prof}


def _beam_config(**kw) -> SamplingConfig:
    return SamplingConfig(**{"num_beams": BEAMS, "do_sample": False,
                             "max_new_tokens": BEAM_NEW_TOKENS, **kw})


def _beam_step_device_ms(bundle, input_ids, pv, pos) -> float:
    """Device ms of one beam step as ``beam_generate`` runs it: the B = BEAMS
    forward (B1 a layer), log-softmax, top-2nb over (nb x V) and the live
    window's reorder, 16 slots into the answer (torch.profiler)."""
    state = beam_mod._BeamState(bundle.model, bundle.config, input_ids, pv, pos, BEAMS,
                                BEAM_NEW_TOKENS, None, bundle.engine.max_seq_len, "none")
    tokens = np.arange(5, 5 + BEAMS, dtype=np.int64)
    scores = torch.zeros(BEAMS, device="cuda")
    idx = torch.arange(BEAMS, device="cuda").flip(0)

    def step():
        if state.slot >= state.S + 16:
            state.slot = state.S + 16  # the same slot each call
        logits = state.forward(tokens)
        flat = (scores[:, None] + F.log_softmax(logits.float(), -1)).reshape(-1)
        torch.topk(flat, 2 * BEAMS)
        beam_mod._reorder_tail(state.cache, idx, state.S, state.slot)

    with torch.no_grad():
        for _ in range(16):
            step()
        return _profiled_device_ms(step)


def _rescored(model, cfg, input_ids, pv, pos, hyp, length_penalty: float) -> float:
    """Teacher-forced score of hypothesis ``hyp`` after the prompt: one
    prefill of prompt + hypothesis (B2), the sum of the hypothesis tokens'
    log-probs over ``len ** length_penalty``."""
    full = np.concatenate([input_ids[0], hyp])[None]
    S, n = input_ids.shape[1], len(hyp)
    with torch.no_grad():
        dt = model.text.final_norm.weight.dtype
        embeds = multimodal_embeds(model, cfg, torch.as_tensor(full, device="cuda"), pos,
                                   torch.as_tensor(pv).to("cuda", dt))
        cache = llama_mod.init_kv_cache(cfg.text_config, 1, 2048, dt, device="cuda")
        valid = torch.zeros(1, 2048, dtype=torch.bool, device="cuda")
        valid[:, :S + n] = True
        hidden, _ = model.text(embeds, torch.arange(S + n, device="cuda")[None], cache, valid, 0)
        lp = F.log_softmax(model.text.logits(hidden[:, S - 1:S + n - 1]).float(), -1)[0]
        total = lp[torch.arange(n, device="cuda"), torch.as_tensor(hyp, device="cuda")].sum()
    return total.item() / n ** length_penalty


def _beam_search(bundle, ids, pv, pos, sampling):
    """``bundle``'s greedy beam search on one prompt row, called as
    ``generate`` calls it but at the engine's level, for the stats it can
    return: (ids, or the top-n list with ``num_return_sequences`` n > 1,
    {"steps", "scores"})."""
    stats = {}
    out = beam_mod.beam_generate(
        bundle.model, bundle.config, ids, pv, pos, num_beams=sampling.num_beams,
        max_new_tokens=sampling.max_new_tokens, eos_token_id=bundle.tokenizer.eos_token_id,
        pad_token_id=bundle.tokenizer.pad_token_id, length_penalty=sampling.length_penalty,
        early_stopping=sampling.early_stopping,
        num_return_sequences=sampling.num_return_sequences,
        cache_slots=bundle.engine.max_seq_len, kv_quant=bundle.engine.kv_quant, stats=stats)
    return out, stats


def phase_beams(smi: str, cfg, tokenizer, bundle) -> dict:
    """Beam search on phase 4's bf16 model, then on an fp32 copy of it."""
    L = cfg.text_config.num_hidden_layers
    model = bundle.model
    image = random_image(SEED)
    beams = _beam_config()
    enc = encoding_text([], PROMPT, bundle.num_patch, tokenizer)
    ids, pv = enc["input_ids"], bundle.image_processor(image)["pixel_values"]
    pos = img_marker_positions(ids, tokenizer.img_start_token_id)
    api.chat(bundle, image, PROMPT, [], beams, verbose=False)  # warm-up: captures
    torch.cuda.synchronize()
    fused, = beam_mod._FUSED[model].values()  # the fused search's workspace

    # the main path's run: one 4-beam chat (the fused search, as the JAX
    # package's default), its launches counted from zero
    passes0 = fused.counts["beam_passes"]
    t0 = time.perf_counter()
    response, counts, _ = _counted_chat(bundle, image, beams)
    chat_s = time.perf_counter() - t0
    passes = fused.counts["beam_passes"] - passes0
    best = bundle.generate(ids, pixel_values=pv, generation_config=beams)[0]
    searched, stats = _beam_search(bundle, ids, pv, pos, beams)
    if searched.tolist() != best.tolist():
        raise RuntimeError(f"beam_generate {searched.tolist()} != generate's (fused) "
                           f"{best.tolist()}")
    steps = stats["steps"]
    if passes < steps:
        raise RuntimeError(f"{passes} fused beam passes for {steps} host beam steps")
    _check_counts(counts, {"flash_prefill": L, "flash_decode": L * passes})
    n_tok = int(np.sum(best != tokenizer.pad_token_id))
    step_ms = _beam_step_device_ms(bundle, ids, pv, pos)
    # the fused search against its eager run and against the host scorer's chat
    kw = dict(num_beams=BEAMS, max_new_tokens=BEAM_NEW_TOKENS,
              eos_token_id=tokenizer.eos_token_id, pad_token_id=tokenizer.pad_token_id,
              cache_slots=bundle.engine.max_seq_len)
    fused_passes0 = fused.counts["beam_passes"]
    fused_ids, fused_s, fused_dev = _timed(fused.graphs, lambda: beam_mod.beam_generate_fused(
        model, cfg, ids, pv, pos, **kw))
    fused_step_ms = fused_dev / max(fused.counts["beam_passes"] - fused_passes0, 1)
    with graphs_mod.eager():
        eager_ids = beam_mod.beam_generate_fused(model, cfg, ids, pv, pos, **kw)
    if fused_ids.tolist() != eager_ids.tolist() or fused_ids.tolist() != best.tolist():
        raise RuntimeError(f"fused beams: captured {fused_ids.tolist()}, eager "
                           f"{eager_ids.tolist()}, chat's {best.tolist()}")
    os.environ["VISUALCLA_BEAM"] = "host"
    try:
        t0 = time.perf_counter()
        host_response, _ = api.chat(bundle, image, PROMPT, [], beams, verbose=False)
        host_s = time.perf_counter() - t0
    finally:
        del os.environ["VISUALCLA_BEAM"]
    if host_response != response:
        raise RuntimeError(f"host-scorer beam chat {host_response!r} != fused {response!r}")

    # two hypotheses, best first: the first is the one-hypothesis search's
    two_cfg = _beam_config(num_return_sequences=2)
    two = bundle.generate(ids, pixel_values=pv, generation_config=two_cfg)
    two_direct, stats2 = _beam_search(bundle, ids, pv, pos, two_cfg)
    scores2 = stats2["scores"]
    if (two.shape[0] != 2 or scores2[0] < scores2[1]
            or two[0, :len(best)].tolist() != best.tolist()
            or any(two[i, :len(h)].tolist() != h.tolist() for i, h in enumerate(two_direct))):
        raise RuntimeError(f"num_return_sequences=2: {two.shape}, scores {scores2[:2]}, first "
                           f"row {two[0].tolist()} vs the best {best.tolist()}")

    # sampled beams on a seeded generator
    sampled_cfg = _beam_config(do_sample=True)
    sampled_ids = bundle.generate(ids, pixel_values=pv, generation_config=sampled_cfg,
                                  seed=SEED)
    sampled, _ = api.chat(bundle, image, PROMPT, [], sampled_cfg, verbose=False, seed=SEED)
    V = cfg.text_config.vocab_size
    if (sampled_ids.ndim != 2 or not len(sampled_ids[0]) or sampled_ids.min() < 0
            or sampled_ids.max() >= V or not isinstance(sampled, str)):
        raise RuntimeError(f"sampled beam chat: ids {sampled_ids.tolist()}")

    # fp32: kernels against plain, the score against a rescoring, batching
    model32 = VisualCLAModel(cfg, device="cuda", dtype=torch.float32)
    model32.load_state_dict(model.state_dict())
    bundle32 = api.VisualCLA(model32, cfg, tokenizer, bundle.image_processor, max_seq_len=2048)
    ids32 = bundle32.generate(ids, pixel_values=pv, generation_config=beams)[0]
    searched32, stats32 = _beam_search(bundle32, ids, pv, pos, beams)
    if searched32.tolist() != ids32.tolist():
        raise RuntimeError(f"fp32 beam_generate {searched32.tolist()} != generate's "
                           f"{ids32.tolist()}")
    score32 = stats32["scores"][0]
    with plain_kernels():
        plain32 = bundle32.generate(ids, pixel_values=pv, generation_config=beams)[0]
    if ids32.tolist() != plain32.tolist():
        raise RuntimeError(f"fp32 beam ids through the kernels {ids32.tolist()} != plain "
                           f"{plain32.tolist()}")
    rescored = _rescored(model32, cfg, ids, pv, pos, ids32, beams.length_penalty)
    if abs(rescored - score32) > 1e-3:
        raise RuntimeError(f"fp32 best hypothesis score {score32} != teacher-forced "
                           f"rescoring {rescored}")
    row1 = ids[0].copy()
    row1[-20:-10] = row1[-20:-10][::-1]  # another instruction, the same length
    batch = np.stack([ids[0], row1])
    small = _beam_config(max_new_tokens=16)
    out2 = bundle32.generate(batch, pixel_values=np.concatenate([pv, pv]),
                             generation_config=small)
    for i in range(2):
        single = bundle32.generate(batch[i:i + 1], pixel_values=pv, generation_config=small)[0]
        got = out2[i]
        want = np.concatenate([single, np.full(len(got) - len(single),
                                               tokenizer.pad_token_id)])
        if got.tolist() != want.tolist():
            raise RuntimeError(f"fp32 batched beam row {i} {got.tolist()} != its single-row "
                               f"run {single.tolist()}")
    del bundle32, model32
    torch.cuda.empty_cache()
    print(f"[4b beams] phase 4's bf16 model, {BEAMS} beams greedy, {BEAM_NEW_TOKENS} new tokens: "
          f"best hypothesis {n_tok} tokens, {steps} beam steps; fused chat {chat_s:.2f} s "
          f"({n_tok / chat_s:.1f} tok/s on the host clock) against the host scorer's "
          f"(VISUALCLA_BEAM=host) {host_s:.2f} s, the same text; launches "
          f"{counts} (B2 once a layer, B1 once a layer a pass at B={BEAMS}: {passes} fused "
          f"passes, gated ones included); fused search captured == eager == host ids, "
          f"{fused_s:.3f} s, device {fused_step_ms:.3f} ms a fused step (CUDA events on the "
          f"replays: forward, log-softmax, top-{2 * BEAMS}, candidate routing, reorder), idle "
          f"share {1 - fused_dev / (fused_s * 1e3):.3f} (prefill included), "
          f"{fused.graphs.captures} captures in {fused.graphs.capture_s:.2f} s; host-path "
          f"device {step_ms:.3f} ms a beam step (torch.profiler: forward, log-softmax, top-{2 * BEAMS}, "
          f"reorder); num_return_sequences=2 best first (scores {scores2[0]:.4f} >= "
          f"{scores2[1]:.4f}); sampled beam chat {len(sampled_ids[0])} valid ids; fp32 copy: "
          f"beam ids kernels == plain ({len(ids32)} tokens), best score {score32:.5f} vs "
          f"teacher-forced rescoring {rescored:.5f} (|diff| {abs(rescored - score32):.2e}, "
          f"limit 1e-3), batched B=2 beam generate equal to its single-row runs; card {smi}",
          flush=True)
    return {"launches": counts, "step_ms": step_ms, "tok_s": n_tok / chat_s,
            "fused_step_ms": fused_step_ms, "fused_chat_s": chat_s, "host_chat_s": host_s}


@contextlib.contextmanager
def _vision_attention(impl: str):
    """Within the block the ViT and the resampler attend with ``impl``
    ("flash": kernel B2u; "xla": the dense path), as ``VISUALCLA_VIT_ATTN``
    selects it."""
    keep = os.environ.get("VISUALCLA_VIT_ATTN")
    os.environ["VISUALCLA_VIT_ATTN"] = impl
    try:
        yield
    finally:
        if keep is None:
            del os.environ["VISUALCLA_VIT_ATTN"]
        else:
            os.environ["VISUALCLA_VIT_ATTN"] = keep


def _counted(fn):
    """``fn()`` with every launch counter set to 0 just before it: (its
    result, the counters read just after)."""
    _reset_counters()
    out = fn()
    torch.cuda.synchronize()
    return out, _counters()


def _encode_ms(model, cfg, px, impl: str, n: int = 5) -> float:
    """Median host ms of one synchronized ``encode_image`` call."""
    times = []
    with _vision_attention(impl), torch.no_grad():
        for _ in range(n + 1):  # the first call is a warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            encode_image(model, cfg, px)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    return statistics.median(times[1:]) * 1e3


def _ttft_ms(bundle, image, impl: str, n: int = 3) -> float:
    """Median TTFT (ms) of a greedy ``chat_in_stream``: from the call to its
    first token (host preprocess, encode, prefill, first sample)."""
    times = []
    with _vision_attention(impl):
        for _ in range(n + 1):  # the first run is a warm-up
            t0 = time.perf_counter()
            for _ in api.chat_in_stream(bundle, image, PROMPT, [], SamplingConfig.greedy(2),
                                        verbose=False):
                break
            times.append(time.perf_counter() - t0)
    return statistics.median(times[1:]) * 1e3


def _vision_times(bundle, image, px, impl: str) -> dict:
    """Encode ms on the host clock and on the device (one ``encode_image``
    captured in a CUDA graph and replayed: launch gaps excluded), TTFT, and
    the captured encode against the eager one (``_encode_times``), with
    vision attention ``impl``."""
    with _vision_attention(impl), torch.no_grad():
        dev = device_ms(lambda i: encode_image(bundle.model, bundle.config, px), calls=1)
        captured = _encode_times(bundle.model, bundle.config, px)
    return {"encode_ms": _encode_ms(bundle.model, bundle.config, px, impl),
            "encode_device_ms": dev, "ttft_ms": _ttft_ms(bundle, image, impl),
            "captured": captured}


def _rel(a, b) -> float:
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


def phase_vision(smi: str, cfg, tokenizer, bundle) -> dict:
    """The vision path with flash vision attention (B2u) on phase 4's bf16
    model: ``encode_image`` on 1 and 8 images (30 B2u launches a call: 24 ViT
    + 6 resampler layers); a greedy chat with exact B2u / B2 / B1 counts;
    ``VisionPipeline.embed_images`` on 8 images; ``evaluate`` on the first 8
    vendored llava questions (generated images under their file names, one
    batch of 8); ``device_preprocess`` against the host processor; the fp32
    vision towers' embeddings flash vs dense; then ``extend_to_resolution
    (448)`` and the same encode and chat (B2u at 1025 tokens).  Encode ms and
    TTFT flash vs dense at 224 and 448 px."""
    L = cfg.text_config.num_hidden_layers
    n_vis = cfg.vision_config.num_hidden_layers + cfg.visual_resampler_config.num_hidden_layers
    model = bundle.model
    image = random_image(SEED)
    images = [random_image(SEED + 40 + i) for i in range(8)]
    greedy = SamplingConfig.greedy(max_new_tokens=VISION_NEW_TOKENS)
    H = cfg.text_config.hidden_size

    def encode(px):
        with torch.no_grad():
            return encode_image(model, bundle.config, px)

    def chat_counts():
        """The greedy chat with its exact launches; -> (tokens, launches)."""
        api.chat(bundle, image, PROMPT, [], greedy, verbose=False)  # warm-up: captures
        _, counts, passes = _counted_chat(bundle, image, greedy)
        enc = encoding_text([], PROMPT, bundle.num_patch, tokenizer)
        pv = bundle.image_processor(image)["pixel_values"]
        ids = bundle.generate(enc["input_ids"], pixel_values=pv, generation_config=greedy)[0]
        if passes["decode_passes"] < len(ids) - 1:
            raise RuntimeError(f"{passes} decode passes for {len(ids)} tokens")
        _check_counts(counts, {"flash_full": n_vis, "flash_prefill": L,
                               "flash_decode": L * passes["decode_passes"]})
        return len(ids), counts

    px8 = torch.as_tensor(bundle.image_processor(images)["pixel_values"]).to("cuda",
                                                                             torch.bfloat16)
    numbers = {}
    with _vision_attention("flash"):
        encode(px8[:1])  # warm-up
        embeds = {}
        for B in (1, 8):
            embeds[B], counts = _counted(lambda: encode(px8[:B]))
            _check_counts(counts, {"flash_full": n_vis})
            if embeds[B].shape != (B, cfg.num_image_tokens, H) or not bool(
                    torch.isfinite(embeds[B]).all()):
                raise RuntimeError(f"encode_image B={B}: {tuple(embeds[B].shape)}, finite "
                                   f"{bool(torch.isfinite(embeds[B]).all())}")
        with plain_kernels():
            plain8 = encode(px8)
        kernel_vs_plain = _rel(embeds[8], plain8)
        n_gen, counts224 = chat_counts()
        enc224 = encoding_text([], PROMPT, bundle.num_patch, tokenizer)
        start224 = _start_times(bundle, enc224["input_ids"],
                                bundle.image_processor(image)["pixel_values"],
                                img_marker_positions(enc224["input_ids"],
                                                     tokenizer.img_start_token_id), greedy)

        pipe = VisionPipeline(model, bundle.config, bundle.image_processor)
        pipe.embed_images(images)  # warm-up: captures the encode of 8 images
        piped, pipe_counts = _counted(lambda: pipe.embed_images(images))
        _check_counts(pipe_counts, {"flash_full": n_vis})
        pipe_diff = float(np.abs(piped - embeds[8].float().cpu().numpy()).max())
        if piped.shape != (8, pipe.num_image_embeds, H) or pipe_diff > 1e-3 * float(
                np.abs(piped).max()):
            raise RuntimeError(f"VisionPipeline {piped.shape}, max diff to encode_image "
                               f"{pipe_diff}")

        with open(golden_path("llava")) as f:
            questions = json.load(f)[:EVAL_QUESTIONS]
        with tempfile.TemporaryDirectory() as tmp:
            for i, name in enumerate(sorted({q["image"] for q in questions})):
                with open(os.path.join(tmp, name), "wb") as f:  # .npy bytes, the file's name
                    np.save(f, random_image(SEED + 50 + i))
            t0 = time.perf_counter()
            prefills0 = bundle.engine.counts["prefill_passes"]
            results, eval_counts = _counted(lambda: evaluate(
                bundle, questions, tmp, sampling=SamplingConfig.greedy(EVAL_NEW_TOKENS),
                batch_size=EVAL_QUESTIONS))
            eval_s = time.perf_counter() - t0
            eval_prefills = bundle.engine.counts["prefill_passes"] - prefills0
        if ([r["question_id"] for r in results] != [q["question_id"] for q in questions]
                or not all(isinstance(r["output"], str) for r in results)):
            raise RuntimeError(f"evaluate returned {results}")
        # one batch: one encode of 8 images and one prefill a prefill pass (the
        # first B=8 start is captured: its warm-up is a pass too); its decode
        # steps end at EOS or the cap
        if eval_prefills not in (1, 2):
            raise RuntimeError(f"evaluate ran {eval_prefills} prefill passes for one batch")
        _check_named(eval_counts, {"flash_full": n_vis * eval_prefills,
                                   "flash_prefill": L * eval_prefills})

    # on-card preprocessing against the host-exact processor
    img_t = torch.as_tensor(image[None], device="cuda")
    dev_px = device_preprocess(img_t)
    pre_ms = event_ms(lambda: device_preprocess(img_t))
    host_px = ImageProcessor(image_size=224)([image])["pixel_values"]
    d = np.abs(dev_px.cpu().numpy() - host_px)
    if dev_px.shape != host_px.shape or np.percentile(d, 99.9) >= 0.05 or d.max() >= 0.3:
        raise RuntimeError(f"device_preprocess vs host: shape {tuple(dev_px.shape)}, p99.9 "
                           f"{np.percentile(d, 99.9)}, max {d.max()}")

    # fp32 vision towers, flash vs dense: the kernel's arithmetic end to end
    towers = VisionTowers(cfg, device="cuda", dtype=torch.float32)
    towers.load_state_dict({k: v for k, v in model.state_dict().items()
                            if k.split(".")[0] in ("vision", "resampler", "projection")})
    px32 = px8[:2].float()
    with torch.no_grad():
        with _vision_attention("flash"):
            flash32 = encode_image(towers, cfg, px32)
        with _vision_attention("xla"):
            dense32 = encode_image(towers, cfg, px32)
    rel32 = _rel(flash32, dense32)
    del towers, flash32, dense32
    if rel32 > 1e-4:
        raise RuntimeError(f"fp32 image embeddings flash vs dense: relative error {rel32}")
    with _vision_attention("xla"):
        dense_bf16 = encode(px8[:1])
    flash_vs_dense = _rel(embeds[1], dense_bf16)
    numbers[224] = {impl: _vision_times(bundle, image, px8[:1], impl) for impl in ("flash", "xla")}

    # 448 px: B2u at 1025 tokens
    bundle.extend_to_resolution(448)
    px448 = torch.as_tensor(bundle.image_processor(image)["pixel_values"]).to("cuda",
                                                                            torch.bfloat16)
    with _vision_attention("flash"):
        e448, counts448 = _counted(lambda: encode(px448))
        _check_counts(counts448, {"flash_full": n_vis})
        with plain_kernels():
            plain448 = encode(px448)
        kernel_vs_plain448 = _rel(e448, plain448)
        n_gen448, chat448 = chat_counts()
    if (tuple(px448.shape) != (1, 3, 448, 448) or model.vision.position_embedding.shape[0] != 1025
            or not bool(torch.isfinite(e448).all())):
        raise RuntimeError(f"448 px: pixels {tuple(px448.shape)}, position table "
                           f"{tuple(model.vision.position_embedding.shape)}")
    if max(kernel_vs_plain, kernel_vs_plain448) > EMBED_REL_TOL:
        raise RuntimeError(f"image embeddings kernels vs plain: relative {kernel_vs_plain} at "
                           f"224 px, {kernel_vs_plain448} at 448 px (limit {EMBED_REL_TOL})")
    numbers[448] = {impl: _vision_times(bundle, image, px448, impl) for impl in ("flash", "xla")}
    times = "; ".join(
        f"{res} px: encode (B=1) flash {n['flash']['encode_ms']:.2f} ms / dense "
        f"{n['xla']['encode_ms']:.2f} ms host clock, {n['flash']['encode_device_ms']:.2f} / "
        f"{n['xla']['encode_device_ms']:.2f} ms device (graph replay), TTFT flash "
        f"{n['flash']['ttft_ms']:.1f} ms / dense {n['xla']['ttft_ms']:.1f} ms; flash "
        f"{_encode_line(n['flash']['captured'])}; dense {_encode_line(n['xla']['captured'])}"
        for res, n in numbers.items())
    print(f"[4v vision] phase 4's model with VISUALCLA_VIT_ATTN=flash: encode_image B=1 and 8 "
          f"launch B2u {n_vis} times a call ({cfg.vision_config.num_hidden_layers} ViT + "
          f"{cfg.visual_resampler_config.num_hidden_layers} resampler layers), nothing else; "
          f"B=8 embeddings kernels vs plain relative {kernel_vs_plain:.3e} (limit "
          f"{EMBED_REL_TOL} here and at 448 px); bf16 B=1 flash vs "
          f"dense relative {flash_vs_dense:.3e}; greedy chat {n_gen} tokens launches "
          f"{counts224}; VisionPipeline.embed_images 8 images -> {piped.shape}, max diff to "
          f"encode_image {pipe_diff:.3e}; evaluate on the first {EVAL_QUESTIONS} llava "
          f"questions (one batch, {EVAL_NEW_TOKENS} new tokens) in {eval_s:.2f} s, launches "
          f"B2u {eval_counts['flash_full']}, B2 {eval_counts['flash_prefill']} "
          f"({eval_prefills} prefill passes); "
          f"device_preprocess (480x640 -> 224) {pre_ms:.3f} ms a call on the card (events), vs host "
          f"p99.9 {np.percentile(d, 99.9):.4f} max {d.max():.4f}; fp32 vision towers flash vs "
          f"dense image embeddings relative {rel32:.3e} (limit 1e-4); extend_to_resolution(448): "
          f"1025 ViT tokens, kernels vs plain relative {kernel_vs_plain448:.3e}, greedy chat "
          f"{n_gen448} tokens launches {chat448}; {times}; flash 224 px {_start_line(start224)}; "
          f"card {smi}", flush=True)
    return {"launches": counts224, "numbers": numbers, "rel32": rel32, "start": start224}


def _random_model(cfg, bits=None):
    """VisualCLA-7B on seeded random bf16 weights made on the card, its text
    tower quantized in place to ``bits`` (4 or 8) if given; seconds taken."""
    gc.collect()  # the previous phase's model, before its memory is reused
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = init_random_(VisualCLAModel(cfg, device="cuda", dtype=torch.bfloat16), gen)
    if bits:
        quantize_text_tower_(model, bits)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def _counted_chat(bundle, image, sampling, text=PROMPT, speculative=False):
    """One chat with every launch counter set to 0 just before it: (response,
    the counters read just after, the forward passes its decode loop ran on
    the card, gated ones included: each launches B1 (or B2 for a verify
    chunk) once a layer)."""
    fa.reset_launch_counts()
    i4.reset_launch_counts()
    passes0 = dict(bundle.engine.counts)
    response, _ = api.chat(bundle, image, text, [], sampling, verbose=False,
                           speculative=speculative)
    torch.cuda.synchronize()
    passes = {k: n - passes0[k] for k, n in bundle.engine.counts.items()}
    return response, {**fa.LAUNCHES, **i4.LAUNCHES}, passes


def _timed(graphs, fn):
    """``fn()`` with the replays of ``graphs`` timed by CUDA events: (its
    result, seconds on the host clock, device ms of the replays)."""
    graphs.start_timing()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, graphs.stop_timing()


def _decode_loop(engine, ids, pv, pos, sampling, eager=False) -> dict:
    """``Engine.start``, then ``Engine.decode`` alone on the host clock:
    replaying the captured chunks, or eagerly inside ``graphs.eager()`` (the
    comparison).  -> its ids, tokens/s after the first token, and for the
    captured run the device ms of its replays (CUDA events), the device ms a
    step (forward pass) and the device's idle share of the loop."""
    state = engine.start(ids, pv, pos, sampling)
    try:
        passes0 = engine.counts["decode_passes"]
        with graphs_mod.eager() if eager else contextlib.nullcontext():
            n, wall, dev = _timed(engine.graphs, lambda: engine.decode(state, sampling))
        passes = engine.counts["decode_passes"] - passes0
        out = state.gen_ids[:, :n].cpu().numpy()
    finally:
        engine.release(state.ws)
    return {"ids": out, "tok_s": (n - 1) / wall,
            "wall_s": wall, "passes": passes, "device_ms": dev,
            "step_ms": dev / max(passes, 1), "idle": 1 - dev / (wall * 1e3)}


def _captured_vs_eager(engine, ids, pv, pos, sampling, label) -> dict:
    """The decode loop captured and eager on the same prompt: equal ids or
    the phase fails.  -> the numbers of both and the engine's graphs."""
    cap = _decode_loop(engine, ids, pv, pos, sampling)
    eag = _decode_loop(engine, ids, pv, pos, sampling, eager=True)
    if cap["ids"].tolist() != eag["ids"].tolist():
        raise RuntimeError(f"{label}: captured decode ids {cap['ids'].tolist()} != eager "
                           f"{eag['ids'].tolist()}")
    g = engine.graphs
    return {"captured_tok_s": cap["tok_s"], "eager_tok_s": eag["tok_s"],
            "step_ms": cap["step_ms"], "idle": cap["idle"],
            "bound_tok_s": 1e3 / cap["step_ms"], "of_bound": cap["tok_s"] * cap["step_ms"] / 1e3,
            "tokens": len(cap["ids"][0]), "captures": g.captures, "capture_s": g.capture_s,
            "pool_gb": g.pool_bytes / 1e9}


def _loop_line(n: dict) -> str:
    return (f"decode loop ({n['tokens']} tokens) captured {n['captured_tok_s']:.1f} tok/s vs "
            f"eager {n['eager_tok_s']:.1f} (host clock, ids equal), device {n['step_ms']:.3f} "
            f"ms a step (CUDA events on the replays: {n['bound_tok_s']:.1f} tok/s device-bound, "
            f"captured at {100 * n['of_bound']:.1f} % of it), idle share {n['idle']:.3f}; "
            f"{n['captures']} captures in {n['capture_s']:.2f} s, graph pool "
            f"{n['pool_gb']:.3f} GB")


def _check_counts(counts, expect):
    """Every kernel of the path launched exactly as expected, every other not."""
    want = {name: expect.get(name, 0) for name in counts}
    for name, n in expect.items():
        if n == 0 or counts.get(name, 0) == 0:
            raise RuntimeError(f"kernel {name} was never launched by the main path")
    if counts != want:
        raise RuntimeError(f"the run launched {counts}, expected {want}")


def _check_named(counts, expect):
    """The named kernels launched exactly as expected (others unchecked)."""
    bad = {name: (counts[name], n) for name, n in expect.items() if counts[name] != n}
    if bad:
        raise RuntimeError(f"launches (got, expected): {bad}")


def _streams(bundle, image, greedy, response, input_ids, pv, ids, text=PROMPT,
             speculative=False):
    """Three greedy ``chat_in_stream`` runs: the same text as ``chat``, the
    stream's ids equal to ``generate``'s; -> median TTFT (s), median decode
    tokens/s, from the stream's clock."""
    ttfts, rates = [], []
    for _ in range(3):
        t_call = time.perf_counter()
        stamps, final = [], ""
        for final, _ in api.chat_in_stream(bundle, image, text, [], greedy, verbose=False,
                                           speculative=speculative):
            stamps.append(time.perf_counter())
        ttfts.append(stamps[0] - t_call)
        if len(stamps) > 1:
            rates.append((len(stamps) - 1) / (stamps[-1] - stamps[0]))
    if final.lstrip(" ") != response.lstrip(" "):
        raise RuntimeError(f"chat_in_stream {final!r} != chat {response!r}")
    stream_ids = [int(t[0]) for t in bundle.stream_generate(input_ids, pv, greedy,
                                                             speculative=speculative)]
    if stream_ids != [int(t) for t in ids]:
        raise RuntimeError(f"stream ids {stream_ids} != generate ids {ids.tolist()}")
    return statistics.median(ttfts), statistics.median(rates)


SPEC_NEW_TOKENS = 64
BEAM_NEW_TOKENS = 32  # phase 4b's beam chats
VISION_NEW_TOKENS = 32  # the vision phase's greedy chats
EVAL_QUESTIONS = 8  # the vision phase's evaluate: one batch of the first llava questions
EVAL_NEW_TOKENS = 16
COPY_PROMPT = "请重复三遍：图片里有一只猫和一只狗。图片里有一只猫和一只狗。图片里有一只猫和一只狗。"


def _spec_chat(bundle, image, expect) -> dict:
    """The greedy speculative chat (spec_k 8, max n-gram 3) of
    SPEC_NEW_TOKENS on a prompt that invites copying: its launches, counted
    from zero, exactly ``expect(verify passes)``; ``chat_in_stream``'s text
    and ``stream_generate``'s ids equal to the blocking ones; the captured
    ``generate`` equal to the eager one; -> its numbers."""
    greedy = SamplingConfig.greedy(max_new_tokens=SPEC_NEW_TOKENS)
    api.chat(bundle, image, COPY_PROMPT, [], greedy, verbose=False,
             speculative=True)  # warm-up: captures
    response, counts, passes = _counted_chat(bundle, image, greedy, COPY_PROMPT,
                                             speculative=True)
    stats = dict(bundle.speculative_decoder().last_stats)
    if passes["spec_passes"] < stats["chunks"]:
        raise RuntimeError(f"{passes} verify passes for {stats['chunks']} chunks")
    _check_counts(counts, expect(passes["spec_passes"]))
    enc = encoding_text([], COPY_PROMPT, bundle.num_patch, bundle.tokenizer)
    pv = bundle.image_processor(image)["pixel_values"]
    eng = bundle.engine
    passes0 = eng.counts["spec_passes"]
    ids, wall, dev = _timed(eng.graphs, lambda: bundle.generate(
        enc["input_ids"], pixel_values=pv, generation_config=greedy, speculative=True)[0])
    timed_passes = eng.counts["spec_passes"] - passes0
    with graphs_mod.eager():
        eager = bundle.generate(enc["input_ids"], pixel_values=pv, generation_config=greedy,
                                speculative=True)[0]
    if ids.tolist() != eager.tolist():
        raise RuntimeError(f"speculative generate: captured {ids.tolist()} != eager "
                           f"{eager.tolist()}")
    ttft, rate = _streams(bundle, image, greedy, response, enc["input_ids"], pv, ids,
                          COPY_PROMPT, speculative=True)
    return {"launches": counts, "tokens": len(ids), "ttft_ms": ttft * 1e3,
            "decode_tok_s": rate, "generate_s": wall, "device_ms": dev,
            "chunk_ms": dev / max(timed_passes, 1), "idle": 1 - dev / (wall * 1e3),
            "passes": passes["spec_passes"], **stats}


def _spec_line(spec: dict) -> str:
    return (f"speculative greedy chat (spec_k 8, copy prompt) {spec['tokens']} tokens in "
            f"{spec['chunks']} chunks ({spec['passes']} verify passes, gated ones included): "
            f"{spec['tokens_per_chunk']:.2f} tokens a chunk, "
            f"acceptance {spec['acceptance']:.3f}, stream ids equal, captured generate == "
            f"eager, launches {spec['launches']}, TTFT {spec['ttft_ms']:.1f} ms, B=1 decode "
            f"{spec['decode_tok_s']:.1f} tok/s (stream); captured generate "
            f"{spec['generate_s']:.3f} s (prefill included), device {spec['chunk_ms']:.3f} ms "
            f"a verify pass (CUDA events on the replays), idle share {spec['idle']:.3f} "
            f"(prefill included)")


def _loose_logits_check(engine, input_ids, pv, pos, label):
    """Prefill logits through the kernels against the plain versions on the
    same model, finite and within a quarter of the logit scale (bf16
    rounding through 32 random layers): (max diff, scale)."""
    kernel_logits, plain_logits = _kernels_vs_plain_logits(engine, input_ids, pv, pos)
    if not bool(torch.isfinite(kernel_logits).all()):
        raise RuntimeError(f"non-finite {label} logits at full width")
    logit_diff = (kernel_logits - plain_logits).abs().max().item()
    logit_scale = plain_logits.abs().max().item()
    if logit_diff > 0.25 * logit_scale:
        raise RuntimeError(f"{label} full-width logits: kernels vs plain differ by "
                           f"{logit_diff} (scale {logit_scale})")
    return logit_diff, logit_scale


def _start_device_ms(eng, input_ids, pv, pos, sampling):
    """Device time of one eager ``Engine.start`` (image encode, splice,
    prefill, first token) under torch.profiler: (all of it in ms, B3's
    prefill form's share in ms, its launches)."""
    def start():
        st = eng.start(input_ids, pv, pos, sampling)
        int(st.last_token[0])
        eng.release(st.ws)

    with graphs_mod.eager():
        start()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start()
            torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    b3 = [e for e in rows if "int4_prefill" in e.key]
    return (sum(e.self_device_time_total for e in rows) / 1e3,
            sum(e.self_device_time_total for e in b3) / 1e3, sum(e.count for e in b3))


def _start_times(bundle, input_ids, pv, pos, sampling) -> dict:
    """``Engine.start`` on a fresh engine of the bundle's model: its first
    call (the capture included), warm captured calls and eager calls, each
    on the host clock (synchronized), the captured replay's device ms (CUDA
    events) and the eager start's (torch.profiler's kernel sum); a warm
    captured start launches what an eager one does and samples the same
    first token, or the phase fails.  Medians of 3."""
    eng = Engine(bundle.model, bundle.config, eos_token_id=bundle.tokenizer.eos_token_id,
                 pad_token_id=bundle.tokenizer.pad_token_id, max_seq_len=2048,
                 kv_quant=bundle.engine.kv_quant)

    def once(eager=False):
        eng.graphs.start_timing()
        _reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with graphs_mod.eager() if eager else contextlib.nullcontext():
            st = eng.start(input_ids, pv, pos, sampling)
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3
        dev = eng.graphs.stop_timing("prefill")
        token = st.last_token.cpu().tolist()
        eng.release(st.ws)
        return host, dev, _counters(), token

    first = once()
    warm = [once() for _ in range(3)]
    eager = [once(eager=True) for _ in range(3)]
    if warm[0][2] != eager[0][2] or warm[0][3] != eager[0][3]:
        raise RuntimeError(f"captured start: launches {warm[0][2]}, first token {warm[0][3]} "
                           f"!= eager {eager[0][2]}, {eager[0][3]}")
    eager_dev, b3_ms, b3_calls = _start_device_ms(eng, input_ids, pv, pos, sampling)
    out = {"first_host_ms": first[0], "first_device_ms": first[1],
           "warm_host_ms": statistics.median(w[0] for w in warm),
           "warm_device_ms": statistics.median(w[1] for w in warm),
           "eager_host_ms": statistics.median(e[0] for e in eager),
           "eager_device_ms": eager_dev, "b3_prefill_ms": b3_ms, "b3_prefill_calls": b3_calls,
           "capture_s": eng.graphs.capture_s, "launches": {k: v for k, v in warm[0][2].items()
                                                           if v}}
    del eng
    return out


def _start_line(n: dict) -> str:
    return (f"Engine.start captured: first call {n['first_host_ms']:.1f} ms host (capture "
            f"{n['capture_s'] * 1e3:.0f} ms of it), warm {n['warm_host_ms']:.2f} ms host / "
            f"{n['warm_device_ms']:.2f} ms device (CUDA events on the replay); eager "
            f"{n['eager_host_ms']:.2f} ms host / {n['eager_device_ms']:.2f} ms device "
            f"(torch.profiler); launches {n['launches']} both ways, first token equal")


def _encode_times(towers, cfg, px) -> dict:
    """``VisionPipeline``'s captured encode (``CapturedEncode``, fresh) of
    ``px`` against ``encode_image`` run eagerly: the first call (capture
    included), warm calls and eager calls on the host clock (synchronized),
    the replay's device ms (CUDA events) and the eager encode's (the same
    calls captured by ``device_ms``); the launches of a warm captured
    encode equal an eager one's and the embeddings agree (bf16 rounding of
    another cuBLAS algorithm at most), or the phase fails.  Medians of 5."""
    enc = CapturedEncode(towers, cfg)

    def once(fn):
        _reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, _counters(), out

    first = once(lambda: enc(px))
    enc.graphs.start_timing()
    warm = [once(lambda: enc(px)) for _ in range(5)]
    warm_dev = enc.graphs.stop_timing("prefill") / 5
    with torch.no_grad():
        eager = [once(lambda: encode_image(towers, cfg, px)) for _ in range(5)]
        eager_dev = device_ms(lambda i: encode_image(towers, cfg, px), calls=1)
    rel = _rel(warm[0][2], eager[0][2])
    if warm[0][1] != eager[0][1] or rel > 1e-2:
        raise RuntimeError(f"captured encode: launches {warm[0][1]} vs eager {eager[0][1]}, "
                           f"relative difference {rel}")
    return {"first_host_ms": first[0], "warm_host_ms": statistics.median(w[0] for w in warm),
            "warm_device_ms": warm_dev, "eager_host_ms": statistics.median(e[0] for e in eager),
            "eager_device_ms": eager_dev, "capture_s": enc.graphs.capture_s, "rel": rel,
            "launches": {k: v for k, v in warm[0][1].items() if v}}


def _encode_line(n: dict) -> str:
    return (f"encode captured: first call {n['first_host_ms']:.1f} ms host, warm "
            f"{n['warm_host_ms']:.2f} ms host / {n['warm_device_ms']:.2f} ms device; eager "
            f"{n['eager_host_ms']:.2f} ms host / {n['eager_device_ms']:.2f} ms device; "
            f"launches {n['launches'] or 'none counted'} both ways, embeddings relative "
            f"{n['rel']:.1e}")


def phase_int4(smi: str, cfg, tokenizer) -> dict:
    """The int4 tier with the int8 KV cache: B3 and the int8-K/V kernels."""
    L = cfg.text_config.num_hidden_layers
    model, setup_s = _random_model(cfg, bits=4)
    bundle = api.VisualCLA(model, cfg, tokenizer, ImageProcessor(image_size=224),
                           max_seq_len=2048, kv_quant="int8")
    image = random_image(SEED)
    greedy = SamplingConfig.greedy(max_new_tokens=32)
    enc = encoding_text([], PROMPT, bundle.num_patch, tokenizer)
    pv = bundle.image_processor(image)["pixel_values"]
    pos = img_marker_positions(enc["input_ids"], tokenizer.img_start_token_id)
    logit_diff, logit_scale = _loose_logits_check(bundle.engine, enc["input_ids"], pv, pos,
                                                  "int4 + int8-KV")
    api.chat(bundle, image, PROMPT, [], greedy, verbose=False)  # warm-up: captures
    response, counts, passes = _counted_chat(bundle, image, greedy)
    ids = bundle.generate(enc["input_ids"], pixel_values=pv, generation_config=greedy)[0]
    n_gen = len(ids)
    # the prompt at its bucket (the head on its last token), then one token a
    # pass, each call in the form the wrapper picks for its shape
    bucket = bundle.engine.bucket_len(enc["input_ids"].shape[1])
    n_pass = passes["decode_passes"]
    if n_pass < n_gen - 1:
        raise RuntimeError(f"{passes} decode passes for {n_gen} tokens")
    expect = {"flash_prefill_kv8": L, "flash_decode_kv8": L * n_pass}
    for name, n in _b3_pass_counts(bucket, L, head_tokens=1).items():
        expect[name] = n + n_pass * _b3_pass_counts(1, L)[name]
    _check_counts(counts, expect)
    loop = _captured_vs_eager(bundle.engine, enc["input_ids"], pv, pos, greedy,
                              "int4 + int8-KV greedy")
    ttft, rate = _streams(bundle, image, greedy, response, enc["input_ids"], pv, ids)
    start = _start_times(bundle, enc["input_ids"], pv, pos, greedy)
    start_ms, b3_ms, b3_calls = (start["eager_device_ms"], start["b3_prefill_ms"],
                                 start["b3_prefill_calls"])
    # a verify chunk runs the 7 matmuls a layer and the head on K+1 = 9 tokens
    sd = bundle.speculative_decoder()
    copy_ids = encoding_text([], COPY_PROMPT, bundle.num_patch, tokenizer)["input_ids"]
    copy_bucket = bundle.engine.bucket_len(copy_ids.shape[1])

    def spec_counts(n_pass):
        counts = {"flash_prefill_kv8": L * (1 + n_pass)}
        for name, n in _b3_pass_counts(copy_bucket, L, head_tokens=1).items():
            counts[name] = n + n_pass * _b3_pass_counts(sd.spec_k + 1, L)[name]
        return counts

    spec = _spec_chat(bundle, image, spec_counts)
    chunk_ms = _spec_chunk_device_ms(
        sd, copy_ids, pv, img_marker_positions(copy_ids, tokenizer.img_start_token_id))
    weight_gb = sum(t.numel() * t.element_size() for t in model.text.parameters()) / 1e9
    print(f"[5 int4] VisualCLA-7B int4 text tower (gs 128, quantized on the card) + int8 KV "
          f"cache, random weights seed {SEED}, built and quantized in {setup_s:.1f} s, text "
          f"tower {weight_gb:.2f} GB; prefill logits kernels vs plain max diff "
          f"{logit_diff:.3e} (scale {logit_scale:.2f}); greedy chat {n_gen} tokens, stream ids "
          f"equal; greedy chat launches {counts}; TTFT {ttft * 1e3:.1f} ms (median of 3), "
          f"Engine.start (encode, prefill at bucket {bundle.engine.bucket_len(enc['input_ids'].shape[1])}"
          f", first token) eager {start_ms:.2f} ms of device time, of which B3's prefill form "
          f"{b3_ms:.2f} ms in {b3_calls} launches (torch.profiler); {_start_line(start)}; "
          f"B=1 decode {rate:.1f} tok/s (chat_in_stream, one captured step a token); "
          f"{_loop_line(loop)}; {_spec_line(spec)}; device {chunk_ms[0]:.2f} ms a "
          f"speculative chunk of {sd.spec_k + 1} tokens ({chunk_ms[1]:.2f} with the parent's "
          f"form choice, its cost model on this tree's kernels; "
          f"torch.profiler, 4 chunks each); card {smi}", flush=True)
    return {"launches": counts, "ttft_ms": ttft * 1e3, "decode_tok_s": rate, "spec": spec,
            "start_device_ms": start_ms, "b3_prefill_device_ms": b3_ms, "start": start,
            "spec_chunk_device_ms": chunk_ms, "loop": loop}


def _spec_chunk_device_ms(sd, input_ids, pv, pos) -> tuple:
    """Device time of one greedy speculative chunk (draft, verify of K+1
    tokens, accept) of the single-stream decoder, after a prefill: (the
    wrapper's B3 forms, the parent's), 4 chunks each under torch.profiler
    (room for 10 chunks of K+1 tokens)."""
    greedy = SamplingConfig.greedy(max_new_tokens=16 * (sd.spec_k + 1))
    spec, prompt_ids, prompt_start = sd._start(input_ids, pv, pos, greedy, 0)

    def chunk():
        nonlocal spec
        spec = sd._chunk(spec, prompt_ids, prompt_start, greedy)

    ours = _profiled_device_ms(chunk)
    with _parent_b3_forms():
        parent = _profiled_device_ms(chunk)
    return ours, parent


def phase_int8(smi: str, cfg, tokenizer) -> dict:
    """The int8 weight tier (bf16 cache): one short greedy chat."""
    model, setup_s = _random_model(cfg, bits=8)
    bundle = api.VisualCLA(model, cfg, tokenizer, ImageProcessor(image_size=224),
                           max_seq_len=2048)
    image = random_image(SEED)
    greedy = SamplingConfig.greedy(max_new_tokens=8)
    enc = encoding_text([], PROMPT, bundle.num_patch, tokenizer)
    pv = bundle.image_processor(image)["pixel_values"]
    pos = img_marker_positions(enc["input_ids"], tokenizer.img_start_token_id)
    logits = model.text.logits(_last_hidden(bundle.engine, enc["input_ids"], pv, pos))
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError("non-finite int8 logits at full width")
    api.chat(bundle, image, PROMPT, [], SamplingConfig.greedy(max_new_tokens=2),
             verbose=False)  # warm-up
    t0 = time.perf_counter()
    stamps = []
    for _ in api.chat_in_stream(bundle, image, PROMPT, [], greedy, verbose=False):
        stamps.append(time.perf_counter())
    rate = (len(stamps) - 1) / (stamps[-1] - stamps[0]) if len(stamps) > 1 else float("nan")
    g = bundle.engine.graphs
    print(f"[6 int8] VisualCLA-7B int8 text tower (quantized on the card), bf16 cache, built "
          f"and quantized in {setup_s:.1f} s; prefill logits finite (scale "
          f"{logits.abs().max().item():.2f}); greedy chat_in_stream {len(stamps)} tokens: TTFT "
          f"{(stamps[0] - t0) * 1e3:.1f} ms, B=1 decode {rate:.1f} tok/s (one stream, one "
          f"captured step a token); {g.captures} captures in {g.capture_s:.2f} s, graph pool "
          f"{g.pool_bytes / 1e9:.3f} GB (Int8Linear's bf16 weight copies are allocated from "
          f"it); card {smi}", flush=True)


GREEDY_OVERRIDES = {"do_sample": False, "repetition_penalty": 1.0, "no_repeat_ngram_size": 0}
# a pure argmax chain, the rows a speculative pool accepts drafts for (the
# engine-wide default keeps top-k 40, which makes a row ineligible)
SPEC_GREEDY = {**GREEDY_OVERRIDES, "top_k": 0}
SERVE_NEW_TOKENS = 32
POOL_ROWS = 8  # PagedServingEngine's default pool_size
SERVE_KW = dict(pool_size=4, block_size=64, num_blocks=64, max_new_tokens_cap=64,
                max_seq_len=2048)


def _npy_b64(image: np.ndarray) -> str:
    buf = io.BytesIO()
    np.save(buf, image)
    return base64.b64encode(buf.getvalue()).decode()


def _chat_request(bundle, tokenizer, image, text=PROMPT):
    """(prompt ids (S,), pixel values, marker position) of a chat turn."""
    ids = encoding_text([], text, bundle.num_patch, tokenizer)["input_ids"]
    pv = bundle.image_processor(image)["pixel_values"]
    return ids[0], pv, int(img_marker_positions(ids, tokenizer.img_start_token_id)[0])


def _http(port: int, path: str, body: dict, record: dict) -> None:
    """POST to the serve handler; streams record the first partial's time."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    record["t0"] = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        if path == "/chat":
            record["result"] = json.loads(r.read())
        else:
            lines = []
            for raw in r:
                if not lines:
                    record["t_first"] = time.perf_counter()
                lines.append(json.loads(raw))
            record["result"] = lines[-1]
            record["partials"] = len(lines) - 1
    record["t_end"] = time.perf_counter()


def _direct(scheduler, req, overrides, record) -> None:
    """A request streamed straight from the scheduler (no HTTP)."""
    ids, pv, img = req
    record["t0"] = time.perf_counter()
    toks = []
    for kind, payload in server_mod.generate_stream(scheduler, ids, pv, img,
                                                    max_new_tokens=SERVE_NEW_TOKENS,
                                                    sampling_overrides=overrides):
        if kind == "token":
            if not toks:
                record["t_first"] = time.perf_counter()
            toks.append(payload)
        else:
            record["result"] = payload
    record["t_end"] = time.perf_counter()


def _run_all(fns) -> None:
    threads = [threading.Thread(target=f) for f in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def _step_logits(engine, ctx):
    """The logits of the engine's next decode step for its live rows, on
    copies of the pools (nothing is committed), inside context ``ctx``."""
    s = engine._state
    run_h = engine._host_active & ~engine._host_finished
    tables = torch.as_tensor(engine.tables, device="cuda")
    lens = torch.as_tensor((engine.ctx_len + run_h).astype(np.int64), device="cuda")
    run = s.active & ~s.finished
    blk, off, lens_attn = engine.decode_inputs(lens, run, tables)
    copy = dataclasses.replace(s, **{k: (getattr(s, k).clone() if getattr(s, k) is not None
                                         else None) for k in POOL_KEYS})
    text = engine.model.text
    with ctx:
        hidden = paged_mod.paged_decode_forward(text, text.embed(s.last_token[:, None]),
                                                s.positions, copy, tables, blk, off, lens_attn)
        return text.logits(hidden)[:, 0]


def _counters() -> dict:
    return {**fa.LAUNCHES, **i4.LAUNCHES, **pa.LAUNCHES, **b7.LAUNCHES, **b8.LAUNCHES}


def _reset_counters() -> None:
    for kernels in (fa, i4, pa, b7, b8):
        kernels.reset_launch_counts()


def _reset_passes(engine) -> None:
    """The engine's forward-pass counters to 0, in place (its graphs add to
    these very dicts when they replay)."""
    for name in engine.counts:
        engine.counts[name] = 0


def _check_serve_counts(engine, stats0, stats1, counts, L, b4_name, b5_name=None):
    """B4 launched once a layer per plain decode pass, B5 (``b5_name``, a
    speculative pool's) once a layer per speculative pass (gated passes of a
    captured chunk included: they run every layer), B2 once a layer per
    tower pass of an admission (``counts["prefill_passes"]``: a one-shot
    admission's, each chunk's, and a capture's warm-up, which runs the stage
    once), no fewer than the Scheduler's prefills and chunks; every other
    attention kernel never.  -> the Scheduler's prefills and chunks."""
    prefills = (stats1["prefills"] - stats0["prefills"]
                + stats1["prefill_chunks"] - stats0["prefill_chunks"])
    if engine.counts["prefill_passes"] < prefills:
        raise RuntimeError(f"{engine.counts['prefill_passes']} tower passes for {prefills} "
                           "prefills and chunks")
    expect = {b4_name: L * engine.counts["decode_passes"],
              "flash_prefill": L * engine.counts["prefill_passes"]}
    if b5_name:
        expect[b5_name] = L * engine.counts["spec_passes"]
    for name in ("paged_append", "paged_append_kv8", "paged_verify", "paged_verify_kv8",
                 "paged_decode", "paged_decode_kv8", "flash_decode", "flash_decode_kv8",
                 "flash_prefill_kv8"):
        expect.setdefault(name, 0)
    bad = {k: (counts[k], v) for k, v in expect.items() if counts[k] != v}
    stepped = engine.spec_steps if b5_name else engine.decode_steps
    if bad or stepped == 0 or prefills == 0:
        raise RuntimeError(f"serve launches (got, expected): {bad}; decode steps "
                           f"{engine.decode_steps}, speculative steps {engine.spec_steps}, "
                           f"passes {engine.counts}, prefills and chunks {prefills}")
    return prefills


def _pool_run(engine, reqs, overrides, n_new, spec: bool, eager: bool) -> dict:
    """Every request admitted at once into its own row, then captured chunks
    of 8 (``step_n(8)``, or ``spec_step_n(4)``) until every row finishes,
    one snapshot a chunk (as the Scheduler reads); eagerly inside
    ``graphs.eager()``.  -> the rows' ids, aggregate tokens/s after the
    admissions, the device ms of the replays and a pass, the idle share."""
    n = len(reqs)
    for row, req in enumerate(reqs):
        engine.prefill_row(row, *req, n_new, overrides=overrides)
    passes0 = dict(engine.counts)
    live0 = engine.decode_steps + getattr(engine, "spec_steps", 0)

    def loop():
        while not engine.snapshot()["finished"][:n].all():
            engine.spec_step_n(4) if spec else engine.step_n(8)
        return engine.snapshot()

    with graphs_mod.eager() if eager else contextlib.nullcontext():
        snap, wall, dev = _timed(engine.graphs, loop)
    engine.release_rows(range(n))
    passes = sum(engine.counts[k] - passes0[k] for k in engine.counts)
    ids = [snap["gen_ids"][r][:snap["gen_len"][r]].tolist() for r in range(n)]
    tokens = sum(len(i) for i in ids) - n  # after the admissions' first tokens
    live = engine.decode_steps + getattr(engine, "spec_steps", 0) - live0
    return {"ids": ids, "tok_s": tokens / wall, "device_ms": dev,
            "pass_ms": dev / max(passes, 1), "idle": 1 - dev / (wall * 1e3), "passes": passes,
            "tokens_per_live": tokens / max(live, 1)}


def _pool_pair(engine, reqs, overrides, n_new, spec: bool, label: str) -> dict:
    """``_pool_run`` captured (after a run that captures its graphs) and
    eager: the ids equal or the phase fails."""
    _pool_run(engine, reqs, overrides, n_new, spec, eager=False)  # captures
    cap = _pool_run(engine, reqs, overrides, n_new, spec, eager=False)
    eag = _pool_run(engine, reqs, overrides, n_new, spec, eager=True)
    if cap["ids"] != eag["ids"]:
        raise RuntimeError(f"{label}: captured pool ids {cap['ids']} != eager {eag['ids']}")
    g = engine.graphs
    return {"captured_tok_s": cap["tok_s"], "eager_tok_s": eag["tok_s"],
            "pass_ms": cap["pass_ms"], "idle": cap["idle"], "passes": cap["passes"],
            "tokens_per_live": cap["tokens_per_live"], "captures": g.captures, "capture_s": g.capture_s, "pool_gb": g.pool_bytes / 1e9}


def _pool_line(n: dict, what: str) -> str:
    return (f"{what}: captured {n['captured_tok_s']:.1f} tok/s aggregate vs eager "
            f"{n['eager_tok_s']:.1f} (host clock, ids equal), device {n['pass_ms']:.3f} ms a "
            f"pass ({n['passes']} passes; CUDA events on the replays), idle share "
            f"{n['idle']:.3f}; {n['captures']} captures in {n['capture_s']:.2f} s, graph pool "
            f"{n['pool_gb']:.3f} GB")


def phase_serve(smi: str, cfg, tokenizer) -> dict:
    """Paged serving at full width: 8 concurrent requests (4 greedy, 2 of
    them over HTTP; the default sampled config, TFS, top-a, mirostat-2) on a
    4-row pool of 64-token blocks, then its numbers, then the fp32 pool
    against single-stream generation."""
    L = cfg.text_config.num_hidden_layers
    model, setup_s = _random_model(cfg)
    bundle = api.VisualCLA(model, cfg, tokenizer,
                           ImageProcessor(image_size=cfg.vision_config.image_size),
                           max_seq_len=2048)
    worker = serve_app.PoolWorker(bundle, paged=True, **{k: v for k, v in SERVE_KW.items()
                                                         if k != "max_seq_len"})
    engine, sched = worker.engine, worker.scheduler
    server = ThreadingHTTPServer(("127.0.0.1", 0), serve_app.make_handler(worker))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    reqs = [_chat_request(bundle, tokenizer, random_image(SEED + i)) for i in range(8)]
    prompt_len = len(reqs[0][0])
    # warm-up: one request, compiles nothing but fills caches and allocators
    server_mod.generate_sync(sched, *reqs[0], max_new_tokens=4,
                             sampling_overrides=GREEDY_OVERRIDES)

    gc_greedy = {**GREEDY_OVERRIDES, "max_new_tokens": SERVE_NEW_TOKENS}
    records = [{} for _ in range(8)]
    fns = [lambda: _http(port, "/chat", {"text": PROMPT, "generation_config": gc_greedy,
                                         "image_b64": _npy_b64(random_image(SEED))},
                         records[0]),
           lambda: _http(port, "/chat_stream", {"text": PROMPT, "generation_config": gc_greedy,
                                                "image_b64": _npy_b64(random_image(SEED + 1))},
                         records[1])]
    overrides = [GREEDY_OVERRIDES, GREEDY_OVERRIDES, None, {"tfs": 0.9}, {"top_a": 0.2},
                 {"mirostat_mode": 2}]
    for i, ov in enumerate(overrides):
        fns.append(lambda i=i, ov=ov: _direct(sched, reqs[i + 2], ov, records[i + 2]))
    _reset_counters()
    _reset_passes(engine)
    engine.decode_steps = 0
    stats0 = sched.stats()
    t0 = time.perf_counter()
    _run_all(fns)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, stats1 = _counters(), sched.stats()
    server.shutdown()
    server.server_close()
    worker.close()
    for i, r in enumerate(records):
        res = r.get("result")
        if res is None:
            raise RuntimeError(f"serve request {i} did not complete: {r}")
        if i < 2:
            if not isinstance(res.get("response"), str) or "history" not in res:
                raise RuntimeError(f"HTTP request {i} returned {res}")
        elif not 1 <= len(res) <= SERVE_NEW_TOKENS or int(res.max()) >= cfg.text_config.vocab_size:
            raise RuntimeError(f"serve request {i} returned {res}")
    if records[1].get("partials", 0) < 1:
        raise RuntimeError("/chat_stream sent no partial response")
    if len(engine._free) != engine.NB - 1 or engine.num_active() != 0:
        raise RuntimeError(f"blocks not returned: {len(engine._free)} free of "
                           f"{engine.NB - 1}, {engine.num_active()} rows active")
    if stats1["chunked_admissions"] == stats0["chunked_admissions"]:
        raise RuntimeError(f"no chunked admission ran: {stats1}")
    prefills = _check_serve_counts(engine, stats0, stats1, counts, L, "paged_append")
    steps, passes = engine.decode_steps, engine.counts["decode_passes"]
    ttfts = sorted((r["t_first"] - r["t0"]) * 1e3 for r in records if "t_first" in r)
    n_tokens = sum(len(r["result"]) for r in records[2:])

    # 4 rows busy: the decode logits through B4 and its plain version, the
    # aggregate decode rate and the device time a step
    for row in range(4):
        engine.prefill_row(row, *reqs[row], 64, overrides=GREEDY_OVERRIDES)
    k_logits = _step_logits(engine, contextlib.nullcontext())
    p_logits = _step_logits(engine, plain_kernels())
    if not bool(torch.isfinite(k_logits).all()):
        raise RuntimeError("non-finite paged decode logits")
    b4_diff = (k_logits - p_logits).abs().max().item()
    b4_scale = p_logits.abs().max().item()
    if b4_diff > 0.25 * b4_scale:
        raise RuntimeError(f"paged decode logits: B4 vs plain differ by {b4_diff} "
                           f"(scale {b4_scale})")
    engine.release_rows(range(4))
    busy = _pool_pair(engine, reqs[:4], GREEDY_OVERRIDES, SERVE_NEW_TOKENS, False,
                      "4 busy greedy rows")
    busy_rate, step_dev_ms = busy["captured_tok_s"], busy["pass_ms"]
    pool_bf16 = engine.pool_bytes()
    del worker, engine, sched
    spec = phase_serve_spec(smi, cfg, tokenizer, model, bundle, reqs[:4], busy_rate)

    # fp32: requests served together through the pool equal, token for
    # token, each one's single-stream Engine.generate (the bf16 pool is not
    # bitwise: cuBLAS rounds by batch shape)
    model32 = VisualCLAModel(cfg, device="cuda", dtype=torch.float32)
    model32.load_state_dict(model.state_dict())
    del bundle, model
    gc.collect()
    torch.cuda.empty_cache()
    bundle32 = api.VisualCLA(model32, cfg, tokenizer,
                             ImageProcessor(image_size=cfg.vision_config.image_size),
                             max_seq_len=2048)
    greedy = SamplingConfig.greedy(SERVE_NEW_TOKENS)
    eng32 = paged_mod.PagedServingEngine(
        model32, cfg, eos_token_id=tokenizer.eos_token_id, pad_token_id=tokenizer.pad_token_id,
        sampling=greedy, **{**SERVE_KW, "pool_size": 3})
    sched32 = server_mod.Scheduler(eng32)
    texts = [PROMPT, "图片里有什么？请回答这个问题，并且详细描述图片中的猫和狗在做什么。", PROMPT]
    reqs32 = [_chat_request(bundle32, tokenizer, random_image(SEED + 10 + i), t)
              for i, t in enumerate(texts)]
    outs32 = [None] * 3

    def serve32(i):
        outs32[i] = server_mod.generate_sync(sched32, *reqs32[i],
                                             max_new_tokens=SERVE_NEW_TOKENS)

    _run_all([lambda i=i: serve32(i) for i in range(3)])
    chunked32 = sched32.stats()["chunked_admissions"]
    sched32.stop()
    # and the speculative pool of 3 on the same requests
    eng32 = paged_mod.PagedServingEngine(
        model32, cfg, eos_token_id=tokenizer.eos_token_id, pad_token_id=tokenizer.pad_token_id,
        sampling=greedy, spec_k=SPEC_K, **{**SERVE_KW, "pool_size": 3})
    sched32 = server_mod.Scheduler(eng32)
    spec32 = [None] * 3

    def serve32_spec(i):
        spec32[i] = server_mod.generate_sync(sched32, *reqs32[i],
                                             max_new_tokens=SERVE_NEW_TOKENS)

    _run_all([lambda i=i: serve32_spec(i) for i in range(3)])
    spec_dispatches32 = sched32.stats()["spec_dispatches"]
    sched32.stop()
    if spec_dispatches32 == 0:
        raise RuntimeError("the fp32 speculative pool ran no speculative dispatch")
    singles = []
    for i, (ids, pv, img) in enumerate(reqs32):
        single = bundle32.generate(ids[None], pixel_values=pv, generation_config=greedy)[0]
        single_spec = bundle32.generate(ids[None], pixel_values=pv, generation_config=greedy,
                                        speculative=True)[0]
        for label, got in (("pool", outs32[i]), ("speculative pool", spec32[i]),
                           ("speculative generate", single_spec)):
            if [int(t) for t in got] != [int(t) for t in single]:
                raise RuntimeError(f"fp32 {label}, request {i}: {list(got)} != single-stream "
                                   f"{single.tolist()}")
        singles.append([int(t) for t in single])
    with graphs_mod.eager():  # its drafters index by host lists, and are not to be captured
        oracle = _oracle_drafts(bundle32, cfg, tokenizer, reqs32, singles)
    del bundle32, model32, eng32, sched32
    print(f"[7 serve] VisualCLA-7B bf16 full width, random weights seed {SEED}, built in "
          f"{setup_s:.1f} s; PagedServingEngine pool 4 rows, 64-token blocks x 64, cap 64 new, "
          f"Smax 2048, Scheduler + HTTP handler on 127.0.0.1; chat prompt {prompt_len} tokens "
          f"(bucket {pick_bucket((128, 256, 512, 1024), prompt_len)}); 8 concurrent requests "
          f"x {SERVE_NEW_TOKENS} new (4 greedy: /chat, /chat_stream, 2 direct; default sampled, "
          f"tfs 0.9, top-a 0.2, mirostat-2) all complete in {wall:.2f} s, {n_tokens} tokens on "
          f"the 6 direct ones; TTFT p50 {statistics.median(ttfts):.1f} ms, max {ttfts[-1]:.1f} "
          f"ms over the {len(ttfts)} streamed; {steps} decode steps, {prefills} prefills and "
          f"chunks ({stats1['chunked_admissions'] - stats0['chunked_admissions']} chunked "
          f"admissions); launches {counts} ({passes} decode passes); "
          f"every block back on the free list; "
          f"{_pool_line(busy, f'4 greedy rows x {SERVE_NEW_TOKENS} new through step_n(8)')}; "
          f"B4 vs plain decode logits max diff {b4_diff:.3e} (scale "
          f"{b4_scale:.2f}); fp32 pool of 3 ({chunked32} chunked admissions), fp32 "
          f"speculative pool of 3 (spec_k {SPEC_K}, {spec_dispatches32} speculative dispatches) "
          f"and fp32 speculative generate (spec_k 8) equal single-stream generate token for "
          f"token; with oracle drafts (the single-stream output) every draft is accepted and "
          f"the tokens stay the same: speculative generate {oracle['generate']:.2f} tokens a "
          f"chunk (acceptance {oracle['acceptance']:.3f}), speculative pool of 3 "
          f"{oracle['pool']:.2f} tokens a step; bf16 pool {pool_bf16 / 1e9:.3f} GB; card {smi}",
          flush=True)
    return {"launches": counts, "ttft_p50_ms": statistics.median(ttfts),
            "decode_tok_s_4_rows": busy_rate, "step_device_ms": step_dev_ms,
            "pool_bytes": pool_bf16, "spec": spec, "busy": busy}


def phase_serve_contiguous(smi: str, cfg, tokenizer) -> dict:
    """The contiguous pool at full width: ``PoolWorker(paged=False)`` (the
    default: ``ServingEngine``, 4 rows, bf16, 2048 slots) under the
    ``Scheduler`` and the HTTP handler; phase 7's 8 concurrent requests
    twice (the first round captures, the second replays), the second with
    exact launch counts (B2 once a layer an admission, B1 once a layer a
    decode pass, nothing else); the first request's TTFT (its captures)
    beside both rounds' p50; 4 busy greedy rows captured and eager; an fp32
    pool of 3 equal to single-stream generation."""
    L = cfg.text_config.num_hidden_layers
    model, setup_s = _random_model(cfg)
    bundle = api.VisualCLA(model, cfg, tokenizer,
                           ImageProcessor(image_size=cfg.vision_config.image_size),
                           max_seq_len=2048)
    worker = serve_app.PoolWorker(bundle, pool_size=4,
                                  max_new_tokens_cap=SERVE_KW["max_new_tokens_cap"])
    engine, sched = worker.engine, worker.scheduler
    if not isinstance(engine, server_mod.ServingEngine):
        raise RuntimeError(f"PoolWorker's default pool is {type(engine).__name__}")
    server = ThreadingHTTPServer(("127.0.0.1", 0), serve_app.make_handler(worker))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    reqs = [_chat_request(bundle, tokenizer, random_image(SEED + i)) for i in range(8)]
    prompt_len = len(reqs[0][0])
    first = {}  # the first request: it captures the admission and the decode step
    _direct(sched, reqs[0], GREEDY_OVERRIDES, first)
    ttft_first = (first["t_first"] - first["t0"]) * 1e3

    gc_greedy = {**GREEDY_OVERRIDES, "max_new_tokens": SERVE_NEW_TOKENS}
    overrides = [GREEDY_OVERRIDES, GREEDY_OVERRIDES, None, {"tfs": 0.9}, {"top_a": 0.2},
                 {"mirostat_mode": 2}]

    def mix(records):
        fns = [lambda: _http(port, "/chat", {"text": PROMPT, "generation_config": gc_greedy,
                                             "image_b64": _npy_b64(random_image(SEED))},
                             records[0]),
               lambda: _http(port, "/chat_stream", {"text": PROMPT,
                                                    "generation_config": gc_greedy,
                                                    "image_b64": _npy_b64(random_image(SEED + 1))},
                             records[1])]
        for i, ov in enumerate(overrides):
            fns.append(lambda i=i, ov=ov: _direct(sched, reqs[i + 2], ov, records[i + 2]))
        _run_all(fns)

    # round 1 captures an admission and a decode graph for each sampler's
    # flags; round 2, the same mix, replays them: its launches are counted
    cold = [{} for _ in range(8)]
    captures0 = engine.graphs.captures
    mix(cold)
    cold_captures = engine.graphs.captures - captures0
    ttfts_cold = sorted((r["t_first"] - r["t0"]) * 1e3 for r in cold if "t_first" in r)
    records = [{} for _ in range(8)]
    _reset_counters()
    _reset_passes(engine)
    engine.snapshot()
    engine.decode_steps = 0
    stats0 = sched.stats()
    admit_graphs = len(engine.graphs._graphs["prefill"])
    t0 = time.perf_counter()
    mix(records)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, stats1 = _counters(), sched.stats()
    # (a decode graph may still be captured: its flags depend on which rows
    # share a step; a capture's warm-up is a decode pass, counted)
    warm_captures = len(engine.graphs._graphs["prefill"]) - admit_graphs
    server.shutdown()
    server.server_close()
    worker.close()
    for i, r in enumerate(records):
        res = r.get("result")
        if res is None:
            raise RuntimeError(f"contiguous serve request {i} did not complete: {r}")
        if i < 2:
            if not isinstance(res.get("response"), str) or "history" not in res:
                raise RuntimeError(f"HTTP request {i} returned {res}")
        elif not 1 <= len(res) <= SERVE_NEW_TOKENS or int(res.max()) >= cfg.text_config.vocab_size:
            raise RuntimeError(f"contiguous serve request {i} returned {res}")
    if records[1].get("partials", 0) < 1:
        raise RuntimeError("/chat_stream sent no partial response")
    if engine.num_active() != 0:
        raise RuntimeError(f"{engine.num_active()} rows still active")
    admissions = stats1["prefills"] - stats0["prefills"]
    passes = dict(engine.counts)
    # every graph replayed: a prefill pass an admission (a capture's warm-up
    # would be a pass too)
    if admissions != 8 or passes["prefill_passes"] != admissions or warm_captures:
        raise RuntimeError(f"{admissions} admissions, {passes['prefill_passes']} prefill "
                           f"passes, {warm_captures} admission captures in the warm round")
    _check_counts(counts, {"flash_prefill": L * passes["prefill_passes"],
                           "flash_decode": L * passes["decode_passes"]})
    ttfts = sorted((r["t_first"] - r["t0"]) * 1e3 for r in records if "t_first" in r)
    n_tokens = sum(len(r["result"]) for r in records[2:])
    steps = engine.decode_steps
    busy = _pool_pair(engine, reqs[:4], GREEDY_OVERRIDES, SERVE_NEW_TOKENS, False,
                      "contiguous pool, 4 busy greedy rows")
    pool_gb = engine.pool_bytes() / 1e9
    state = model.state_dict()
    del worker, engine, sched, bundle, model
    gc.collect()
    torch.cuda.empty_cache()

    # fp32: a pool of 3 equal to single-stream generate, token for token
    model32 = VisualCLAModel(cfg, device="cuda", dtype=torch.float32)
    model32.load_state_dict(state)
    del state
    bundle32 = api.VisualCLA(model32, cfg, tokenizer,
                             ImageProcessor(image_size=cfg.vision_config.image_size),
                             max_seq_len=2048)
    greedy = SamplingConfig.greedy(SERVE_NEW_TOKENS)
    eng32 = server_mod.ServingEngine(
        model32, cfg, eos_token_id=tokenizer.eos_token_id, pad_token_id=tokenizer.pad_token_id,
        pool_size=3, max_seq_len=2048, max_new_tokens_cap=SERVE_KW["max_new_tokens_cap"],
        sampling=greedy)
    sched32 = server_mod.Scheduler(eng32)
    texts = [PROMPT, "图片里有什么？请回答这个问题，并且详细描述图片中的猫和狗在做什么。", PROMPT]
    reqs32 = [_chat_request(bundle32, tokenizer, random_image(SEED + 10 + i), t)
              for i, t in enumerate(texts)]
    outs32 = [None] * 3

    def serve32(i):
        outs32[i] = server_mod.generate_sync(sched32, *reqs32[i],
                                             max_new_tokens=SERVE_NEW_TOKENS)

    _run_all([lambda i=i: serve32(i) for i in range(3)])
    sched32.stop()
    for i, (ids, pv, img) in enumerate(reqs32):
        single = bundle32.generate(ids[None], pixel_values=pv, generation_config=greedy)[0]
        if [int(t) for t in outs32[i]] != [int(t) for t in single]:
            raise RuntimeError(f"fp32 contiguous pool, request {i}: {list(outs32[i])} != "
                               f"single-stream {single.tolist()}")
    del bundle32, model32, eng32, sched32
    print(f"[7c serve contiguous] VisualCLA-7B bf16 full width, random weights seed {SEED}, "
          f"built in {setup_s:.1f} s; PoolWorker(paged=False): ServingEngine 4 rows x 2048 "
          f"slots (cache {pool_gb:.3f} GB), cap {SERVE_KW['max_new_tokens_cap']} new, Scheduler "
          f"+ HTTP handler on 127.0.0.1; chat prompt {prompt_len} tokens (bucket "
          f"{pick_bucket((128, 256, 512, 1024), prompt_len)}); first request TTFT "
          f"{ttft_first:.1f} ms (its admission and decode captures included); 8 concurrent "
          f"requests x {SERVE_NEW_TOKENS} new (4 greedy: /chat, /chat_stream, 2 direct; default "
          f"sampled, tfs 0.9, top-a 0.2, mirostat-2), first round ({cold_captures} captures "
          f"inside it, a pair for each new sampler's flags): TTFT p50 "
          f"{statistics.median(ttfts_cold):.1f} ms, max {ttfts_cold[-1]:.1f} ms; the same "
          f"mix again, every graph replayed: all complete in {wall:.2f} s, {n_tokens} "
          f"tokens on the 6 direct ones; TTFT p50 {statistics.median(ttfts):.1f} ms, max "
          f"{ttfts[-1]:.1f} ms over the {len(ttfts)} streamed; {admissions} admissions in "
          f"{passes['prefill_passes']} prefill passes, {steps} live decode steps in "
          f"{passes['decode_passes']} decode passes; launches {counts} (B2 = 32 x prefill "
          f"passes, B1 = 32 x decode passes exactly); "
          f"{_pool_line(busy, f'4 greedy rows x {SERVE_NEW_TOKENS} new through step_n(8)')}; "
          f"fp32 pool of 3 equal to single-stream generate token for token; card {smi}",
          flush=True)
    return {"launches": counts, "ttft_p50_ms": statistics.median(ttfts),
            "ttft_p50_cold_ms": statistics.median(ttfts_cold), "ttft_first_ms": ttft_first,
            "busy": busy}


def _oracle_drafts(bundle32, cfg, tokenizer, reqs, singles) -> dict:
    """The acceptance path with drafts known to be right: each row's drafter
    returns its next K tokens of the single-stream output, so in fp32 every
    draft is accepted and the tokens must stay the single-stream ones.  The
    speculative decoder (spec_k 8, one request at a time) and an fp32
    speculative pool of 3 (spec_k SPEC_K, rows driven directly) -> tokens a
    chunk and acceptance, tokens a pool step."""
    from visualcla_tpu_torch.engine import paged_spec, speculative

    greedy = SamplingConfig.greedy(SERVE_NEW_TOKENS)
    width = SERVE_NEW_TOKENS + 16
    future = torch.tensor([w + [0] * (width - len(w)) for w in singles], device="cuda")
    prompt_len = torch.tensor([len(ids) for ids, _, _ in reqs], device="cuda")

    def ahead(rows, gen_len, k):  # future[rows, gen_len + j], j < k
        idx = (gen_len[:, None] + torch.arange(k, device="cuda")[None, :]).clamp(max=width - 1)
        return future[rows][torch.arange(len(rows), device="cuda")[:, None], idx]

    saved = speculative.ngram_draft, paged_spec.draft_all_rows
    tpc, acc = [], []
    try:
        dec = bundle32.speculative_decoder()
        for i, (ids, pv, img) in enumerate(reqs):
            bucket = bundle32.engine.bucket_len(len(ids))
            speculative.ngram_draft = (
                lambda ctx, start, end, k, n, i=i, bucket=bucket: ahead([i], end - bucket, k))
            got = dec.generate(ids[None], pv, np.array([img]), greedy)[0]
            if [int(t) for t in got] != singles[i]:
                raise RuntimeError(f"fp32 speculative generate with oracle drafts, request {i}: "
                                   f"{got.tolist()} != {singles[i]}")
            tpc.append(dec.last_stats["tokens_per_chunk"])
            acc.append(dec.last_stats["acceptance"])
        engine = paged_mod.PagedServingEngine(
            bundle32.model, cfg, eos_token_id=tokenizer.eos_token_id,
            pad_token_id=tokenizer.pad_token_id, sampling=greedy, spec_k=SPEC_K,
            **{**SERVE_KW, "pool_size": 3})
        paged_spec.draft_all_rows = (
            lambda all_ids, total_len, k, n: ahead(list(range(3)), total_len - prompt_len, k))
        for row, (ids, pv, img) in enumerate(reqs):
            engine.prefill_row(row, ids, pv, img, SERVE_NEW_TOKENS)
        while not engine.snapshot()["finished"][:3].all():
            engine.spec_step_n(8)
        snap = engine.snapshot()
        for row in range(3):
            got = [int(t) for t in snap["gen_ids"][row][:snap["gen_len"][row]]]
            if got != singles[row]:
                raise RuntimeError(f"fp32 speculative pool with oracle drafts, row {row}: "
                                   f"{got} != {singles[row]}")
        pool = (int(snap["gen_len"][:3].sum()) - 3) / max(engine.spec_steps, 1)
    finally:
        speculative.ngram_draft, paged_spec.draft_all_rows = saved
    if min(acc) < 0.5:
        raise RuntimeError(f"oracle drafts were rejected: acceptance {acc}")
    return {"generate": statistics.mean(tpc), "acceptance": min(acc), "pool": pool}


REPEAT_TEXTS = ("猫狗猫狗猫狗猫狗猫狗猫狗猫狗猫狗猫狗猫狗猫狗猫狗猫狗猫狗猫狗猫狗",
                "图片里有一只猫。图片里有一只猫。图片里有一只猫。图片里有一只猫。")


def phase_serve_spec(smi: str, cfg, tokenizer, model, bundle, busy_reqs, plain_rate) -> dict:
    """The speculative pool on phase 7's bf16 model: ``PagedServingEngine(
    spec_k=SPEC_K)``, 4 rows, under the Scheduler; 6 requests (4 greedy, 2
    of them repetitive; the default sampled config; TFS) complete with
    speculative dispatches and exact launch counts; then the aggregate rate
    and tokens a speculative step with phase 7's 4 busy rows."""
    L = cfg.text_config.num_hidden_layers
    engine = paged_mod.PagedServingEngine(
        model, cfg, eos_token_id=tokenizer.eos_token_id, pad_token_id=tokenizer.pad_token_id,
        spec_k=SPEC_K, **SERVE_KW)
    sched = server_mod.Scheduler(engine)
    texts = (PROMPT, PROMPT) + REPEAT_TEXTS + (PROMPT, PROMPT)
    overrides = [SPEC_GREEDY] * 4 + [None, {"tfs": 0.9}]
    reqs = [_chat_request(bundle, tokenizer, random_image(SEED + 30 + i), t)
            for i, t in enumerate(texts)]
    server_mod.generate_sync(sched, *reqs[0], max_new_tokens=4,
                             sampling_overrides=SPEC_GREEDY)  # warm-up
    _reset_counters()
    _reset_passes(engine)
    engine.decode_steps = engine.spec_steps = 0
    stats0 = sched.stats()
    records = [{} for _ in reqs]
    t0 = time.perf_counter()
    _run_all([lambda i=i: _direct(sched, reqs[i], overrides[i], records[i])
              for i in range(len(reqs))])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, stats1 = _counters(), sched.stats()
    sched.stop()
    for i, r in enumerate(records):
        res = r.get("result")
        if res is None or not 1 <= len(res) <= SERVE_NEW_TOKENS:
            raise RuntimeError(f"speculative serve request {i}: {r}")
    if len(engine._free) != engine.NB - 1 or engine.num_active() != 0:
        raise RuntimeError(f"speculative serve: {len(engine._free)} blocks free of "
                           f"{engine.NB - 1}, {engine.num_active()} rows active")
    dispatches = stats1["spec_dispatches"] - stats0["spec_dispatches"]
    if dispatches == 0:
        raise RuntimeError(f"the speculative pool ran no speculative dispatch: {stats1}")
    prefills = _check_serve_counts(engine, stats0, stats1, counts, L, "paged_append",
                                   "paged_verify")
    spec_steps, decode_steps, passes = engine.spec_steps, engine.decode_steps, dict(engine.counts)
    n_tokens = sum(len(r["result"]) for r in records)

    # 4 rows busy, phase 7's requests: speculative iterations only
    busy = _pool_pair(engine, busy_reqs, SPEC_GREEDY, SERVE_NEW_TOKENS, True,
                      "4 busy speculative rows")
    busy_rate, step_dev_ms = busy["captured_tok_s"], busy["pass_ms"]
    per_step = busy["tokens_per_live"]
    print(f"[7b serve spec] the same model, PagedServingEngine spec_k {SPEC_K} (max n-gram "
          f"{engine.spec_max_ngram}, speculative up to {engine.spec_max_active} rows), 4 rows, "
          f"Scheduler; 6 concurrent requests x {SERVE_NEW_TOKENS} new (4 greedy, 2 of them "
          f"repetitive; default sampled; tfs 0.9) all complete in {wall:.2f} s, {n_tokens} "
          f"tokens; {dispatches} speculative and "
          f"{stats1['chunk_dispatches'] - stats0['chunk_dispatches']} plain chunk dispatches, "
          f"{spec_steps} speculative iterations, {decode_steps} plain decode steps, "
          f"{prefills} prefills and chunks; launches {counts} ({passes}); every block "
          f"back; 4 rows busy (phase 7's requests, greedy): {per_step:.2f} tokens a live "
          f"speculative iteration; "
          f"{_pool_line(busy, f'4 greedy rows x {SERVE_NEW_TOKENS} new through spec_step_n(4)')}"
          f" against phase 7's plain {plain_rate:.1f}; card {smi}", flush=True)
    return {"launches": counts, "decode_tok_s_4_rows": busy_rate,
            "tokens_per_spec_step": per_step, "step_device_ms": step_dev_ms, "busy": busy}


def phase_serve_int4(smi: str, cfg, tokenizer) -> dict:
    """A short serve at the int4 tier with the int8 KV pool: 3 greedy
    requests, exact launch counts of B4's int8 form, finite decode logits;
    then 2 greedy requests on a speculative int8 pool (B5's int8 form, B3 at
    B(K+1) tokens)."""
    L = cfg.text_config.num_hidden_layers
    model, setup_s = _random_model(cfg, bits=4)
    bundle = api.VisualCLA(model, cfg, tokenizer,
                           ImageProcessor(image_size=cfg.vision_config.image_size),
                           max_seq_len=2048)
    engine = paged_mod.PagedServingEngine(
        model, cfg, eos_token_id=tokenizer.eos_token_id, pad_token_id=tokenizer.pad_token_id,
        sampling=SamplingConfig.greedy(SERVE_NEW_TOKENS), kv_quant="int8", **SERVE_KW)
    sched = server_mod.Scheduler(engine)
    reqs = [_chat_request(bundle, tokenizer, random_image(SEED + 20 + i)) for i in range(3)]
    server_mod.generate_sync(sched, *reqs[0], max_new_tokens=2)  # warm-up
    _reset_counters()
    _reset_passes(engine)
    engine.decode_steps = 0
    stats0 = sched.stats()
    outs = [None] * 3

    def serve(i):
        outs[i] = server_mod.generate_sync(sched, *reqs[i], max_new_tokens=SERVE_NEW_TOKENS)

    _run_all([lambda i=i: serve(i) for i in range(3)])
    torch.cuda.synchronize()
    counts, stats1 = _counters(), sched.stats()
    sched.stop()
    prefills = _check_serve_counts(engine, stats0, stats1, counts, L, "paged_append_kv8")
    if counts["int4_matmul_decode"] == 0 or counts["int4_matmul_prefill"] == 0:
        raise RuntimeError(f"the int4 serve did not launch B3: {counts}")
    if any(o is None or len(o) == 0 for o in outs) or len(engine._free) != engine.NB - 1:
        raise RuntimeError(f"int4 serve: outputs {outs}, {len(engine._free)} blocks free")
    engine.prefill_row(0, *reqs[0], 8)
    logits = _step_logits(engine, contextlib.nullcontext())
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError("non-finite int4 + int8-pool decode logits")
    engine.release_rows([0])
    pool_int8 = engine.pool_bytes()
    decode_steps = engine.decode_steps
    busy = _pool_pair(engine, reqs, None, SERVE_NEW_TOKENS, False, "int4 3 greedy rows")
    del engine, sched

    spec = paged_mod.PagedServingEngine(
        model, cfg, eos_token_id=tokenizer.eos_token_id, pad_token_id=tokenizer.pad_token_id,
        sampling=SamplingConfig.greedy(SERVE_NEW_TOKENS), kv_quant="int8", spec_k=SPEC_K,
        **SERVE_KW)
    sched = server_mod.Scheduler(spec)
    server_mod.generate_sync(sched, *reqs[0], max_new_tokens=4)  # warm-up
    _reset_counters()
    _reset_passes(spec)
    spec.decode_steps = spec.spec_steps = 0
    stats0 = sched.stats()
    spec_outs = [None] * 2

    def serve_spec(i):
        spec_outs[i] = server_mod.generate_sync(sched, *reqs[i], max_new_tokens=SERVE_NEW_TOKENS)

    _run_all([lambda i=i: serve_spec(i) for i in range(2)])
    torch.cuda.synchronize()
    spec_counts, stats1 = _counters(), sched.stats()
    sched.stop()
    spec_prefills = _check_serve_counts(spec, stats0, stats1, spec_counts, L, "paged_append_kv8",
                                        "paged_verify_kv8")
    if spec_counts["int4_matmul_decode"] == 0 or any(o is None or len(o) == 0
                                                     for o in spec_outs):
        raise RuntimeError(f"int4 speculative serve: outputs {spec_outs}, launches "
                           f"{spec_counts}")
    step_ms = _int4_pool_step_device_ms(model, cfg, tokenizer, reqs)
    cont = _contiguous_int4(model, cfg, tokenizer, reqs)
    print(f"[8 serve int4] VisualCLA-7B int4 text tower (quantized on the card) with the int8 "
          f"KV pool, built in {setup_s:.1f} s; 3 concurrent greedy requests x "
          f"{SERVE_NEW_TOKENS} new complete ({[len(o) for o in outs]} tokens); "
          f"{decode_steps} decode steps, {prefills} prefills and chunks; launches "
          f"{counts}; decode logits finite (scale {logits.abs().max().item():.2f}); int8 pool "
          f"{pool_int8 / 1e9:.3f} GB with its scales; speculative int8 pool (spec_k {SPEC_K}, "
          f"speculative up to {spec.spec_max_active} rows at this tier): 2 greedy requests "
          f"({[len(o) for o in spec_outs]} tokens), {spec.spec_steps} speculative iterations, "
          f"{spec.decode_steps} plain steps, {spec_prefills} prefills and chunks, launches "
          f"{spec_counts}; {_pool_line(busy, f'the 3 requests again, rows driven directly through step_n(8)')}; "
          f"a pool of the default {POOL_ROWS} rows, every row decoding (eager): device "
          f"{step_ms[0]:.2f} ms a decode step ({step_ms[1]:.2f} with the parent's form choice, "
          f"its cost model on this tree's kernels; torch.profiler, 4 steps "
          f"each); the contiguous pool (ServingEngine, 4 rows, bf16 cache) at this tier: 3 "
          f"greedy requests ({cont['tokens']} tokens) in {cont['prefill_passes']} prefill and "
          f"{cont['decode_passes']} decode passes, launches {cont['launches']} exactly (B3's "
          f"decode form at T = 4 rows, its prefill form at the bucket); card {smi}", flush=True)
    return {"launches": counts, "pool_bytes": pool_int8, "spec_launches": spec_counts,
            "pool_step_device_ms": step_ms, "busy": busy, "contiguous": cont}


def _contiguous_int4(model, cfg, tokenizer, reqs) -> dict:
    """3 greedy requests on a 4-row contiguous pool over the int4 text tower
    under the Scheduler: B2 and B1 once a layer a prefill and a decode pass,
    B3 in the form its wrapper picks at the bucket (prefill, the head on one
    token) and at T = 4 rows (decode), exactly."""
    L = cfg.text_config.num_hidden_layers
    engine = server_mod.ServingEngine(
        model, cfg, eos_token_id=tokenizer.eos_token_id, pad_token_id=tokenizer.pad_token_id,
        pool_size=4, max_seq_len=2048, max_new_tokens_cap=SERVE_KW["max_new_tokens_cap"],
        sampling=SamplingConfig.greedy(SERVE_NEW_TOKENS))
    sched = server_mod.Scheduler(engine)
    server_mod.generate_sync(sched, *reqs[0], max_new_tokens=2)  # warm-up: captures
    _reset_counters()
    _reset_passes(engine)
    outs = [None] * 3

    def serve(i):
        outs[i] = server_mod.generate_sync(sched, *reqs[i], max_new_tokens=SERVE_NEW_TOKENS)

    _run_all([lambda i=i: serve(i) for i in range(3)])
    torch.cuda.synchronize()
    counts = _counters()
    sched.stop()
    if any(o is None or len(o) == 0 for o in outs):
        raise RuntimeError(f"contiguous int4 serve: outputs {outs}")
    p, d = engine.counts["prefill_passes"], engine.counts["decode_passes"]
    bucket = engine.bucket_len(len(reqs[0][0]))
    expect = {"flash_prefill": L * p, "flash_decode": L * d}
    for name, n in _b3_pass_counts(bucket, L, head_tokens=1).items():
        expect[name] = p * n + d * _b3_pass_counts(engine.B, L)[name]
    _check_counts(counts, {k: v for k, v in expect.items() if v})
    return {"launches": counts, "prefill_passes": p, "decode_passes": d,
            "tokens": [len(o) for o in outs]}


def _int4_pool_step_device_ms(model, cfg, tokenizer, reqs) -> tuple:
    """Device time of one decode step of an int4 + int8-pool
    ``PagedServingEngine`` of the default ``POOL_ROWS`` rows, every row
    decoding (B3 at T = POOL_ROWS): (the wrapper's B3 forms, the parent's)."""
    engine = paged_mod.PagedServingEngine(
        model, cfg, eos_token_id=tokenizer.eos_token_id, pad_token_id=tokenizer.pad_token_id,
        sampling=SamplingConfig.greedy(SERVE_NEW_TOKENS), kv_quant="int8",
        **{**SERVE_KW, "pool_size": POOL_ROWS, "num_blocks": 96})  # 8 blocks a prompt
    for row in range(POOL_ROWS):
        engine.prefill_row(row, *reqs[row % len(reqs)], 64)
    with graphs_mod.eager():  # the profiler times the eager step's kernels
        ours = _profiled_device_ms(engine.step)
        with _parent_b3_forms():
            parent = _profiled_device_ms(engine.step)
    engine.release_rows(range(POOL_ROWS))
    return ours, parent


def _private_kb() -> int:
    """This process's anonymous resident memory in kB: ``RssAnon`` of
    ``/proc/self/status``, or where that line is missing (the card's
    sandbox) the sum of the ``Anonymous:`` lines of ``/proc/self/smaps``."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("RssAnon:"):
                return int(line.split()[1])
    with open("/proc/self/smaps") as f:
        return sum(int(line.split()[1]) for line in f if line.startswith("Anonymous:"))


def _rss_gb() -> tuple:
    """This process's resident set now and its private part, in GB: the
    total (``/proc/self/statm``) counts the file pages of mmapped pickles,
    the private part (``_private_kb``) only the memory the process made
    itself.  Where those files cannot be read, the peak so far
    (``getrusage``) twice."""
    try:
        with open("/proc/self/statm") as f:
            total = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 1e9
        return total, _private_kb() * 1024 / 1e9
    except (OSError, ValueError, IndexError):
        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
        return peak, peak


class _PeakRss:
    """The largest resident set and the largest private part seen while the
    block runs, sampled every 50 ms from a thread: the kernel's own peak
    counts the whole process's life and cannot be restarted in every
    sandbox (a read of ``smaps`` takes ~8 ms on the card's machine)."""

    def _sample(self):
        total, anon = _rss_gb()
        self.peak, self.private = max(self.peak, total), max(self.private, anon)

    def __enter__(self):
        self.peak, self.private = _rss_gb()
        self._stop = threading.Event()

        def sample():
            while not self._stop.wait(0.05):
                self._sample()

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self._sample()


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def _io_step(label: str, fn, nbytes_fn):
    """Run ``fn`` with the peak RSS restarted: (result, its line)."""
    gc.collect()
    before, before_private = _rss_gb()
    with _PeakRss() as rss:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
    n = nbytes_fn()
    return out, (f"{label} {sec:.2f} s, {n / 1e9:.2f} GB at {n / 1e9 / sec:.2f} GB/s, peak RSS "
                 f"{rss.peak:.2f} GB (from {before:.2f}), of it private (anonymous pages) "
                 f"{rss.private:.2f} GB (from {before_private:.2f})")


def _ulps(got: torch.Tensor, want: torch.Tensor) -> int:
    """The largest distance in bf16 units in the last place between two
    bf16 tensors (values of opposite sign count only if not both tiny)."""
    a, b = got.view(torch.int16).int(), want.view(torch.int16).int()
    same = (a < 0) == (b < 0)
    tiny = (got.float().abs() < 1e-30) & (want.float().abs() < 1e-30)
    d = torch.where(same, (a - b).abs(), torch.where(tiny, 0, 1 << 16))
    return int(d.max())


BASE_VOCAB_CUT = 4  # Chinese-Alpaca-Plus-7B's 49954 rows under VisualCLA's 49958 tokens


def _cut_text_base(model, merged: str, out_dir: str) -> int:
    """A text base dir over the export's ``text_encoder/`` whose embedding
    and LM head lack the last ``BASE_VOCAB_CUT`` rows, as the reference's
    base LLaMA lacks VisualCLA's added tokens: the export's pickle linked as
    shard 1, the cut tables written as shard 2 (later shards win), an HF
    index over both.  -> the base's rows."""
    os.makedirs(out_dir)
    src = os.path.join(merged, "text_encoder")
    shards = ("pytorch_model-00001-of-00002.bin", "pytorch_model-00002-of-00002.bin")
    os.symlink(os.path.join(src, "pytorch_model.bin"), os.path.join(out_dir, shards[0]))
    os.symlink(os.path.join(src, "config.json"), os.path.join(out_dir, "config.json"))
    rows = model.text.embed_tokens.shape[0] - BASE_VOCAB_CUT
    cut = {"model.embed_tokens.weight": model.text.embed_tokens.detach()[:rows],
           "lm_head.weight": model.text.lm_head.weight.detach()[:rows]}
    torch.save({k: v.cpu().contiguous() for k, v in cut.items()},
               os.path.join(out_dir, shards[1]))
    keys = torch.load(os.path.join(out_dir, shards[0]), map_location="cpu", mmap=True,
                      weights_only=True).keys()
    weight_map = {k: shards[1] if k in cut else shards[0] for k in keys}
    with open(os.path.join(out_dir, "pytorch_model.bin.index.json"), "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)
    return rows


def _fabricated_adapter(model, cfg, tokenizer, out_dir: str, rank: int = 8) -> dict:
    """A rank-``rank`` composite VisualCLA adapter in PEFT layout over every
    text and vision projection, with full resampler and projector weights
    (drawn on the card, written as fp32 ``adapter_model.bin``), the full
    embedding and LM head as ``modules_to_save`` (``model``'s own bf16
    tables, at the tokenizer's vocabulary), its configs and the tokenizer.
    -> {base state key: (A, B)} on the card."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    sd, pairs = {}, {}
    names = {"text": (("q_proj", "self_attn.q_proj"), ("k_proj", "self_attn.k_proj"),
                      ("v_proj", "self_attn.v_proj"), ("o_proj", "self_attn.o_proj"),
                      ("gate_proj", "mlp.gate_proj"), ("up_proj", "mlp.up_proj"),
                      ("down_proj", "mlp.down_proj")),
             "vision": (("q_proj", "self_attn.q_proj"), ("k_proj", "self_attn.k_proj"),
                        ("v_proj", "self_attn.v_proj"), ("o_proj", "self_attn.out_proj"),
                        ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2"))}
    prefix = {"text": "base_model.model.text_model.model.layers.{}.",
              "vision": "base_model.model.vision_model.vision_model.encoder.layers.{}."}
    for tower, pairs_of in names.items():
        for l, layer in enumerate(getattr(model, tower).layers):
            for mod, ref in pairs_of:
                out_f, in_f = getattr(layer, mod).weight.shape
                a = torch.randn(rank, in_f, generator=gen, device="cuda") / in_f ** 0.5
                b = torch.randn(out_f, rank, generator=gen, device="cuda") * 0.02
                key = prefix[tower].format(l) + ref
                sd[key + ".lora_A.weight"], sd[key + ".lora_B.weight"] = a, b
                pairs[f"{tower}.layers.{l}.{mod}.weight"] = (a, b)
    res = init_random_(Resampler(cfg.visual_resampler_config, device="cuda",
                                 dtype=torch.float32), gen)
    leaves = {k.split("/", 1)[1]: v for k, v in
              params_to_jax(torch.nn.ModuleDict({"resampler": res})).items()}
    sd.update({"base_model.model." + k: v
               for k, v in sd_from_tower_leaves(leaves, "resampler").items()})
    th, vh = cfg.text_config.hidden_size, cfg.vision_config.hidden_size
    sd["base_model.model.image_projection_layer.weight"] = torch.randn(
        th, vh, generator=gen, device="cuda") * 0.02
    sd["base_model.model.image_projection_layer.bias"] = torch.randn(
        th, generator=gen, device="cuda") * 0.02
    saved = {k: v.float().cpu().contiguous() for k, v in sd.items()}
    text = "base_model.model.text_model."
    saved[text + "model.embed_tokens.modules_to_save.default.weight"] = (
        model.text.embed_tokens.detach().cpu().contiguous())
    saved[text + "lm_head.modules_to_save.default.weight"] = (
        model.text.lm_head.weight.detach().cpu().contiguous())
    os.makedirs(out_dir, exist_ok=True)
    torch.save(saved, os.path.join(out_dir, "adapter_model.bin"))
    del saved
    with open(os.path.join(out_dir, "adapter_config.json"), "w") as f:
        json.dump({"peft_type": "LORA", "r": rank, "lora_alpha": 2 * rank,
                   "fan_in_fan_out": False, "bias": "none"}, f)
    cfg.save_pretrained(out_dir)
    tokenizer.sp.save(os.path.join(out_dir, "tokenizer.model"))
    with open(os.path.join(out_dir, "added_tokens.json"), "w") as f:
        json.dump(tokenizer.added_tokens, f)
    return pairs


def phase_reference(smi: str, cfg, tokenizer, phase4_ids) -> dict:
    """The reference's checkpoint layouts at full width and depth: export,
    the merged load, the vision pipeline and the unmerged load."""
    model, _ = _random_model(cfg)  # phase 4's model: the same seed, the same bits
    image = random_image(SEED)
    greedy = SamplingConfig.greedy(max_new_tokens=32)
    enc = encoding_text([], PROMPT, cfg.num_image_tokens, tokenizer)
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        merged = os.path.join(tmp, "merged")
        free_gb = shutil.disk_usage(tmp).free / 1e9
        _, line = _io_step("export_reference_merged (bfloat16)", lambda: export_reference_merged(
            model, cfg, merged, dtype="bfloat16", tokenizer=tokenizer), lambda: _dir_bytes(merged))
        lines.append(line)

        (bundle, tok2, _), line = _io_step(
            "merged load", lambda: api.get_model_and_tokenizer_and_processor(
                visualcla_model=merged, device="cuda", max_seq_len=2048),
            lambda: _dir_bytes(merged))
        lines.append(line)
        want = model.state_dict()
        got = bundle.model.state_dict()
        diff = [k for k in want if not torch.equal(want[k], got[k])]
        if set(want) != set(got) or diff:
            raise RuntimeError(f"merged load: state differs from phase 4's at {diff[:5]}; keys "
                               f"{sorted(set(want) ^ set(got))[:5]}")
        pv = bundle.image_processor(image)["pixel_values"]
        ids = bundle.generate(enc["input_ids"], pixel_values=pv, generation_config=greedy)[0]
        if ids.tolist() != phase4_ids.tolist():
            raise RuntimeError(f"merged load: greedy ids {ids.tolist()} != phase 4's "
                               f"{phase4_ids.tolist()}")
        del bundle
        gc.collect()
        torch.cuda.empty_cache()

        pipe, line = _io_step("VisionPipeline.from_reference_merged", lambda: VisionPipeline.
                              from_reference_merged(merged, device="cuda"),
                              lambda: _dir_bytes(merged) - _dir_bytes(
                                  os.path.join(merged, "text_encoder")))
        lines.append(line)
        with torch.no_grad():
            want_e = encode_image(model, cfg, torch.as_tensor(pv).to("cuda", torch.bfloat16))
        got_e = pipe.embed_images([image])
        if got_e.shape != tuple(want_e.shape) or not np.array_equal(
                got_e, want_e.float().cpu().numpy()):
            raise RuntimeError(f"VisionPipeline.from_reference_merged embeddings differ from "
                               f"encode_image: max {np.abs(got_e - want_e.float().cpu().numpy()).max()}")
        del pipe

        # the unmerged path: the export's towers as the bases (the text base's
        # tables cut to the base LLaMA's vocabulary), a fabricated adapter
        lora = os.path.join(tmp, "lora")
        text_base = os.path.join(tmp, "text_base")
        base_rows = _cut_text_base(model, merged, text_base)
        pairs = _fabricated_adapter(model, cfg, tokenizer, lora)
        (ub, _, _), line = _io_step(
            f"unmerged load (text base with {base_rows}-row tables + vision_encoder/ + rank-8 "
            f"LoRA, resized to {len(tokenizer)} rows and folded on the card)",
            lambda: api.get_model_and_tokenizer_and_processor(
                text_model=text_base, vision_model=os.path.join(merged, "vision_encoder"),
                lora_model=lora, device="cuda", max_seq_len=2048),
            lambda: _dir_bytes(os.path.join(merged, "text_encoder"))
            + _dir_bytes(os.path.join(merged, "vision_encoder")) + _dir_bytes(lora))
        lines.append(line)
        state = ub.model.state_dict()
        tables = ("text.embed_tokens", "text.lm_head.weight")
        if any(not torch.equal(state[k], want[k]) for k in tables):
            raise RuntimeError(f"unmerged load: {tables} differ from the adapter's "
                               f"modules_to_save rows (shapes {[state[k].shape for k in tables]})")
        worst = 0
        with torch.no_grad():
            for key, (a, b) in pairs.items():
                w = want[key]
                folded = (w.float() + 2.0 * (b.float() @ a.float())).to(w.dtype)
                worst = max(worst, _ulps(state[key], folded))
        if worst > 1:
            raise RuntimeError(f"unmerged fold: {worst} bf16 ulps from an independent fp32 fold")
        logits = ub.model.text.logits(_last_hidden(ub.engine, enc["input_ids"], pv,
                                                   img_marker_positions(
                                                       enc["input_ids"],
                                                       tokenizer.img_start_token_id)))
        un_resp, _ = api.chat(ub, image, PROMPT, [], greedy, verbose=False)
        if not bool(torch.isfinite(logits).all()) or not isinstance(un_resp, str):
            raise RuntimeError("unmerged load: non-finite prefill logits")
        del ub
    del model
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[9 reference] VisualCLA-7B full width and depth ({free_gb:.0f} GB free in the temporary "
          f"directory): " + "; ".join(lines) + f"; merged load state bit for bit phase 4's, "
          f"greedy ids equal ({len(ids)} tokens); VisionPipeline.from_reference_merged embeddings "
          f"equal encode_image's; unmerged fold of {len(pairs)} projections within {worst} bf16 "
          f"ulp of an independent fp32 fold, {base_rows}-row base tables resized to {len(tokenizer)} rows "
          f"then replaced by the adapter's modules_to_save rows bit for bit, greedy chat with finite "
          f"logits; card {smi}",
          flush=True)
    return {"lines": lines}


# ---------------------------------------------------------------------------
# phase 11: training (no hand kernel on (a)-(d)'s paths; B3 on (e)'s)
# ---------------------------------------------------------------------------

TRAIN_LR = 1e-4
# (c): the tiny model's step on the card against the CPU, fp32 without TF32
TRAIN_RTOL, TRAIN_ATOL = 1e-5, 1e-6
# (d): logits of the adapter folded at load (fp32) against the bf16-saved
# merged checkpoint: bf16 rounding of the merged weights
FOLD_RTOL, FOLD_ATOL = 2e-2, 5e-2
# (e): the tiny fp32 int4 step on the card against the CPU: loss and
# grad_norm relative, each gradient against the largest (``_int4_card_vs_cpu``)
INT4_TRAIN_TOL = (5e-4, 1.5e-2, 2e-2)


def _step_rounds_away(p: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor, count: int,
                      lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> bool:
    """True if Adam's last step (from its moments) is below half an ulp of
    every value of ``p`` in its dtype, so no value could move: a bf16 norm
    weight at 1.0 under lr 1e-4, or a leaf whose gradients are far below
    Adam's eps (random weights' near-uniform attention starves the vision
    q/k adapters)."""
    if p.dtype == torch.float32:
        return False
    x = p.float()
    u = lr * (mu.float() / (1 - b1 ** count)) / ((nu.float() / (1 - b2 ** count)).sqrt() + eps)
    _, e = torch.frexp(x)  # |x| = m 2^e, m in [0.5, 1): one ulp is 2^(e-1) eps
    half = torch.ldexp(torch.full_like(x, torch.finfo(p.dtype).eps / 2), e - 1)
    half = torch.where(x == 0, torch.full_like(x, torch.finfo(p.dtype).tiny), half)
    return bool((u.abs() < half).all())


def _train_run(model, cfg, batch, trainable, steps: int, base: int,
               expect: dict = None) -> dict:
    """``steps`` subset steps (constant lr TRAIN_LR, remat) of ``model`` on
    one batch, the first a warm-up: losses, step ms by CUDA events and the
    host clock (p50 of the timed steps), the peak memory of the steps, the
    hand-kernel launches they made (exactly ``expect``, by kernel; none by
    default), and the checks: finite losses, every frozen leaf bitwise
    unchanged (against a copy on the card, left out of the peak, as is
    ``base``: what was allocated before the model was made), every
    trainable leaf changed (but those whose last step is below half an ulp
    of every value: ``_step_rounds_away``)."""
    from visualcla_tpu_torch.train.trainer import (init_train_state, make_optimizer,
                                                   make_train_step_subset, partition_params)

    opt = make_optimizer(learning_rate=TRAIN_LR, schedule="const")
    train, frozen = partition_params(model, trainable)
    state = init_train_state(train, opt)
    step = make_train_step_subset(model, cfg, opt, trainable, remat=True)
    with torch.no_grad():
        before_frozen = {n: p.clone() for n, p in frozen.items()}
        before_train = {n: p.clone() for n, p in train.items()}
    snapshot = nbytes(*before_frozen.values()) + nbytes(*before_train.values())
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    losses, dev, host = [], [], []
    for i in range(steps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        state, m = step(state, frozen, batch)
        b.record()
        torch.cuda.synchronize()
        if i:
            host.append((time.perf_counter() - t0) * 1e3)
            dev.append(a.elapsed_time(b))
        losses.append(float(m["loss"]))
    peak_gb = (torch.cuda.max_memory_allocated() - snapshot - base) / 1e9
    launches = {k: v for k, v in _counters().items() if v}
    bad = [n for n, p in frozen.items() if not torch.equal(p, before_frozen[n])]
    still = [n for n, p in train.items() if torch.equal(p, before_train[n])]
    mu, nu, count = state.opt_state["mu"], state.opt_state["nu"], state.opt_state["count"]
    exempt = [n for n in still if _step_rounds_away(train[n], mu[n], nu[n], count, TRAIN_LR)]
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite training loss: {losses}")
    if launches != (expect or {}):
        raise RuntimeError(f"the training steps launched {launches}, expected {expect or {}}")
    if bad:
        raise RuntimeError(f"{len(bad)} frozen leaves changed, e.g. {bad[:4]}")
    if set(still) - set(exempt):
        raise RuntimeError(f"trainable leaves unchanged: {sorted(set(still) - set(exempt))[:4]}")
    del before_frozen, before_train
    n_train = sum(p.numel() for p in train.values())
    q = sum(p.numel() for p in frozen.values() if p.dtype == torch.int8)
    return {"losses": losses, "ms": statistics.median(dev), "host_ms": statistics.median(host),
            "peak_gb": peak_gb, "trainable_m": n_train / 1e6, "frozen": len(frozen),
            "int8_elems": q, "exempt": exempt, "snapshot_gb": snapshot / 1e9,
            "launches": launches}


def _train_line(r: dict, flops: dict, tokens: int, smi: str) -> str:
    tflop = flops["total"] / 1e12
    return (f"losses {[round(x, 4) for x in r['losses']]}; step p50 {r['ms']:.1f} ms device "
            f"(CUDA events) / {r['host_ms']:.1f} ms host, {tokens / r['ms'] * 1e3:.0f} tokens/s; "
            f"peak {r['peak_gb']:.2f} GB (max_memory_allocated less what the earlier phases "
            f"left allocated and the {r['snapshot_gb']:.2f} GB copy kept for the frozen-bits "
            f"check); {r['trainable_m']:.1f} M trainable "
            f"parameters; model FLOPs {tflop:.2f} T a step, mfu "
            f"{tflop / (r['ms'] / 1e3) / (BF16_OPS_PER_S / 1e12):.3f} of 989 TFLOP/s; card {smi}")


def _tiny_train_batch(cfg, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    B, S = 2, 24
    ids = rng.integers(5, cfg.text_config.vocab_size, (B, S))
    labels = ids.copy()
    labels[:, :cfg.num_image_tokens + 4] = -100
    mask = np.ones((B, S), np.int64)
    mask[1, -3:] = 0
    labels[1, -3:] = -100
    size = cfg.vision_config.image_size
    return {"input_ids": ids, "attention_mask": mask, "labels": labels,
            "img_start_pos": np.asarray([1, 1]),
            "pixel_values": rng.standard_normal((B, 3, size, size)).astype(np.float32)}


def _card_vs_cpu() -> dict:
    """(c): one stage-2 subset step of the tiny fp32 model (non-zero LoRA B)
    on the card and on the CPU from the same weights."""
    import copy

    from visualcla_tpu_torch.core.config import tiny_visualcla_config
    from visualcla_tpu_torch.train.lora import add_lora, lora_trainable
    from visualcla_tpu_torch.train.trainer import (init_train_state, make_optimizer,
                                                   make_train_step_subset, partition_params)

    cfg = tiny_visualcla_config()
    gen = torch.Generator().manual_seed(SEED)
    cpu = init_random_(VisualCLAModel(cfg, dtype=torch.float32), gen, std=0.1)
    add_lora(cpu, r=4, alpha=8.0, generator=gen)
    with torch.no_grad():
        for n, p in cpu.named_parameters():
            if n.endswith("lora_B"):
                p.normal_(0.0, 0.05, generator=gen)
    card = copy.deepcopy(cpu).to("cuda")
    batch = _tiny_train_batch(cfg)
    out = {}
    for name, model in (("cpu", cpu), ("cuda", card)):
        opt = make_optimizer(learning_rate=1e-3, schedule="const")
        train, frozen = partition_params(model, lora_trainable)
        step = make_train_step_subset(model, cfg, opt, lora_trainable)
        _, m = step(init_train_state(train, opt), frozen, batch)
        out[name] = (float(m["loss"]), float(m["grad_norm"]),
                     {n: p.detach().cpu() for n, p in train.items()})
    (l0, g0, p0), (l1, g1, p1) = out["cpu"], out["cuda"]
    worst = max(float((p1[n] - p0[n]).abs().max()) for n in p0)
    for what, a, b in (("loss", l1, l0), ("grad_norm", g1, g0)):
        if abs(a - b) > TRAIN_RTOL * abs(b):
            raise RuntimeError(f"(c) {what} on the card {a} vs the CPU {b}")
    for n in p0:
        if not torch.allclose(p1[n], p0[n], rtol=TRAIN_RTOL, atol=TRAIN_ATOL):
            raise RuntimeError(f"(c) {n} after the step: max |diff| "
                               f"{float((p1[n] - p0[n]).abs().max()):.3e}")
    return {"loss": (l1, l0), "grad_norm": (g1, g0), "worst": worst, "n": len(p0)}


def _cli_end_to_end(tokenizer, smi: str) -> dict:
    """(d): ``run_training.main`` on the card over a tiny native checkpoint
    (hidden 512: the chat's kernels take 128-wide heads) with the run's
    tokenizer; a resume from step_2; the output through the factory and a
    greedy chat; the adapter folded by the unmerged loader against it."""
    from visualcla_tpu_torch.checkpoint.serialize import load_checkpoint, save_checkpoint
    from visualcla_tpu_torch.core.config import tiny_visualcla_config
    from visualcla_tpu_torch.train import run_training
    from visualcla_tpu_torch.train.trainer import batch_to_device, train_forward_logits

    cfg = tiny_visualcla_config(vocab_size=len(tokenizer), hidden_size=512)
    model = init_random_(VisualCLAModel(cfg, dtype=torch.float32),
                         torch.Generator().manual_seed(SEED))
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "ckpt")
        save_checkpoint(ckpt, params_to_jax(model), cfg, dtype="float32")
        tokenizer.sp.save(os.path.join(ckpt, "tokenizer.model"))
        with open(os.path.join(ckpt, "added_tokens.json"), "w") as f:
            json.dump(tokenizer.added_tokens, f)
        rng = np.random.default_rng(SEED)
        for name in ("a.npy", "b.npy"):
            np.save(os.path.join(tmp, name), rng.integers(0, 256, (60, 80, 3), dtype=np.uint8))
        data = os.path.join(tmp, "d.jsonl")
        with open(data, "w") as f:
            for rec in ({"image": "a.npy", "instruction": "图片里有什么？", "response": "一只猫。"},
                        {"image": "b.npy", "instruction": "描述这张图片。", "response": "狗在上"},
                        {"image": "a.npy", "caption": "一只猫和一只狗"},
                        {"instruction": "你好", "response": "你好！"}):
                f.write(json.dumps(rec, ensure_ascii=False) + "\n")
        out, out2 = os.path.join(tmp, "out"), os.path.join(tmp, "out2")
        args = ["--checkpoint", ckpt, "--data", data, "--image_dir", tmp, "--stage", "2",
                "--steps", "3", "--epochs", "2", "--batch_size", "2", "--lora_r", "4",
                "--log_every", "1", "--warmup_steps", "1", "--remat"]
        t0 = time.perf_counter()
        state = run_training.main(args + ["--output", out, "--save_every", "2"])
        t_run = time.perf_counter() - t0
        resumed = run_training.main(args + ["--output", out2, "--resume",
                                            os.path.join(out, "train_state", "step_2")])
        if state.step != 3 or resumed.step != 3:
            raise RuntimeError(f"(d) steps {state.step} / {resumed.step}, expected 3")
        a = torch.load(os.path.join(out, "adapter", "adapter_model.bin"), weights_only=True)
        b = torch.load(os.path.join(out2, "adapter", "adapter_model.bin"), weights_only=True)
        resume_diff = max(float((a[k] - b[k]).abs().max()) for k in a)
        if set(a) != set(b) or resume_diff > TRAIN_ATOL:
            raise RuntimeError(f"(d) the resumed run's adapter differs by {resume_diff:.3e}")

        bundle, tok2, _ = api.get_model_and_tokenizer_and_processor(
            visualcla_model=out, device="cuda", max_seq_len=512)
        reply, _ = api.chat(bundle, random_image(SEED), PROMPT, [],
                            SamplingConfig.greedy(max_new_tokens=8), verbose=False)
        del bundle

        base, _ = load_checkpoint(ckpt, device="cuda", dtype=torch.float32)
        ref = os.path.join(tmp, "ref")
        export_reference_merged(base, cfg, ref, dtype="float32", side_files_from=ckpt)
        del base
        adapter = os.path.join(out, "adapter")
        for name in ("tokenizer.model", "added_tokens.json", "config.json"):
            shutil.copy(os.path.join(ckpt, name), os.path.join(adapter, name))
        merged, _ = load_checkpoint(out, device="cuda", dtype=torch.float32)
        folded, _, _ = api.get_model_and_tokenizer_and_processor(
            text_model=os.path.join(ref, "text_encoder"),
            vision_model=os.path.join(ref, "vision_encoder"), lora_model=adapter,
            dtype=torch.float32, device="cuda")
        batch = _tiny_train_batch(cfg, seed=1)
        logits = []
        for m in (merged, folded.model):
            bt = batch_to_device(m, batch)
            with torch.no_grad():
                logits.append(train_forward_logits(m, cfg, bt["input_ids"],
                                                   bt["attention_mask"], bt["img_start_pos"],
                                                   bt["pixel_values"]))
        fold_diff = float((logits[0] - logits[1]).abs().max())
        if not torch.allclose(logits[1], logits[0], rtol=FOLD_RTOL, atol=FOLD_ATOL):
            raise RuntimeError(f"(d) the folded adapter's logits differ by {fold_diff:.3e}")
        del merged, folded
    return {"seconds": t_run, "resume_diff": resume_diff, "fold_diff": fold_diff,
            "reply_chars": len(reply)}


def _b3_train_counts(steps: int, T: int, layers: int) -> dict:
    """B3's launches, by form, of ``steps`` remat training steps over the 7B
    int4 text tower at T tokens: each step's forward (7 a layer, then the
    head: ``_b3_pass_counts``) and the recompute of every layer in the
    backward (7 a layer again); the backward itself launches none (dX is a
    dequantize and one cuBLAS product)."""
    counts = _b3_pass_counts(T, layers)
    for in_dim, out in LAYER_SHAPES.values():
        counts[_b3_form(T, in_dim, out)] += layers
    return {k: steps * v for k, v in counts.items() if v}


def _int4_head_dx(model, T: int) -> dict:
    """B3 under autograd at the int4 head's shape (T tokens, 4096 -> 49958,
    fp32 out): the forward through the kernel (one launch), dX through
    ``Int4MatmulFn``'s backward against ``int4_matmul_grad_ref`` within
    B3_TOL of its largest value, the backward's dequantize bitwise
    ``dequantize_grouped``'s; the device ms (CUDA events, 3 calls) of the
    forward and of the backward, and the backward's bound: the carrier,
    scales and g read once and dX written once, against its product's
    operations at the bf16 rate."""
    head = model.text.lm_head
    q, s = head.q, head.scale
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(T, 2 * q.shape[0] * q.shape[1], generator=gen,
                    device="cuda").to(torch.bfloat16).requires_grad_(True)
    g = torch.randn(T, q.shape[2], generator=gen, device="cuda")
    _reset_counters()
    y = i4.int4_matmul(x, q, s, out_dtype=torch.float32)
    launches = {k: v for k, v in _counters().items() if v}
    y.backward(g)
    ref = i4.int4_matmul_grad_ref(g, q, s, torch.bfloat16).float()
    err = float((x.grad.float() - ref).abs().max())
    if not torch.equal(i4._dequantized(q, s, torch.bfloat16),
                       dequantize_grouped(q, s, torch.bfloat16)):
        raise RuntimeError("(e) the backward's dequantize differs from dequantize_grouped")
    if not (err <= B3_TOL * float(ref.abs().max()) and bool(torch.isfinite(x.grad).all())):
        raise RuntimeError(f"(e) the head's dX through Int4MatmulFn differs by {err:.3e}")
    if launches != {_b3_form(T, *HEAD_SHAPE): 1}:
        raise RuntimeError(f"(e) the head's forward under autograd launched {launches}")

    def backward():
        x.grad = None
        i4.int4_matmul(x, q, s, out_dtype=torch.float32).backward(g)

    total = event_ms(backward, 3)
    fwd = event_ms(lambda: i4.int4_matmul(x.detach(), q, s, out_dtype=torch.float32), 3)
    in_dim, out = HEAD_SHAPE
    moved = nbytes(q, s, g) + 2 * T * in_dim  # the function's inputs and its bf16 dX
    b_ms, b_by = bound(moved, 2.0 * T * in_dim * out)
    return {"err": err, "ms": total - fwd, "fwd_ms": fwd, "bound_ms": b_ms, "bound_by": b_by}


def _int4_card_vs_cpu() -> dict:
    """The tiny fp32 stage-1 step's gradients over an int4 text tower
    (``quantize_text_tower_(model, 4)``: int4 layers and head, gs 16 and
    32) on the card, through B3's decode form, against the CPU's plain
    version.  B3 rounds its fp32 input to bf16 (relative 2^-9), the plain
    version does not, so the two agree to that rounding: INT4_TRAIN_TOL
    holds at least 4x what that rounding alone makes on the CPU
    (``tests/test_torch_train.py::test_int4_card_tolerance_covers_b3_rounding``,
    seeds 0-2)."""
    import copy

    from visualcla_tpu_torch.core.config import tiny_visualcla_config
    from visualcla_tpu_torch.train.trainer import loss_fn, partition_params, stage1_trainable

    cfg = tiny_visualcla_config()
    cpu = init_random_(VisualCLAModel(cfg, dtype=torch.float32),
                       torch.Generator().manual_seed(SEED), std=0.1)
    quantize_text_tower_(cpu, 4)
    card = copy.deepcopy(cpu).to("cuda")
    batch = _tiny_train_batch(cfg)
    out = {}
    _reset_counters()
    for name, model in (("cpu", cpu), ("cuda", card)):
        train, _ = partition_params(model, stage1_trainable)
        loss = loss_fn(model, cfg, batch)
        loss.backward()
        grads = {n: p.grad.detach().cpu() for n, p in train.items() if p.grad is not None}
        norm = float(torch.linalg.vector_norm(torch.stack([g.norm() for g in grads.values()])))
        out[name] = (float(loss.detach()), norm, grads)
    launches = {k: v for k, v in _counters().items() if v}
    (l0, n0, g0), (l1, n1, g1) = out["cpu"], out["cuda"]
    top = max(float(g.abs().max()) for g in g0.values())
    worst = max(float((g1[n] - g0[n]).abs().max()) for n in g0) / top
    loss_tol, norm_tol, grad_tol = INT4_TRAIN_TOL
    if set(g0) != set(g1) or not launches:
        raise RuntimeError(f"(e) tiny step: leaves {len(g0)} / {len(g1)}, launches {launches}")
    for what, a, b, tol in (("loss", l1, l0, loss_tol), ("grad_norm", n1, n0, norm_tol)):
        if not abs(a - b) <= tol * abs(b):
            raise RuntimeError(f"(e) tiny int4 step: {what} on the card {a} vs the CPU {b}")
    if not worst <= grad_tol:
        raise RuntimeError(f"(e) tiny int4 step: a gradient differs by {worst:.3e} of the "
                           f"largest")
    return {"loss": (l1, l0), "grad_norm": (n1, n0), "worst": worst, "n": len(g0),
            "launches": launches}


def phase_train(smi: str, cfg, tokenizer) -> dict:
    """(a) a full-width VisualCLA-7B stage-2 QLoRA step, (b) a stage-1 step at
    full width, (c) the tiny model's step on the card against the CPU, (d)
    the training CLI end to end."""
    from visualcla_tpu_torch.fixtures import (TRAIN_SEQ, train_batch, train_model,
                                              train_step_flops)
    from visualcla_tpu_torch.train.lora import lora_trainable
    from visualcla_tpu_torch.train.trainer import stage1_trainable

    gc.collect()
    torch.cuda.empty_cache()
    batch = train_batch(cfg, tokenizer)
    numbers = {}
    L = cfg.text_config.num_hidden_layers
    for key, stage, trainable, steps, bits in (("stage2", 2, lora_trainable, 6, None),
                                               ("stage1", 1, stage1_trainable, 2, None),
                                               ("stage1_int4", 1, stage1_trainable, 2, 4)):
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        model = train_model(cfg, stage, bits=bits)
        torch.cuda.synchronize()
        made = time.perf_counter() - t0
        expect = _b3_train_counts(steps, TRAIN_SEQ, L) if bits == 4 else None
        r = _train_run(model, cfg, batch, trainable, steps, base, expect)
        if stage == 2 and not r["losses"][-1] < r["losses"][0]:
            raise RuntimeError(f"(a) the loss did not fall: {r['losses']}")
        flops = train_step_flops(cfg, stage, TRAIN_SEQ)
        label = {"stage2": "(a) VisualCLA-7B stage-2 QLoRA (int8 decoder, bf16 embed/head/"
                           "vision/resampler/projection, bf16 LoRA r=8 on text and vision), "
                           f"remat, B=1 S={TRAIN_SEQ}, 1 warm + 5 timed steps",
                 "stage1": "(b) stage 1 at full width (bf16 text tower frozen; vision, "
                           "resampler, projection trainable), remat, 1 warm + 1 timed step",
                 "stage1_int4": "(e) stage 1 at full width over the frozen int4 text tower "
                                "(fixtures.train_model(bits=4): int4 layers and head, gs 128, "
                                "per-row int8 table; B3 forward and in the remat recompute, "
                                "dX by Int4MatmulFn), remat, 1 warm + 1 timed step"}[key]
        quant = (f"{r['int8_elems'] / 1e9:.2f} G int8 carrier values among them" if bits is None
                 else "the uint8 carriers and f32 scales among them")
        print(f"[11 train] {label} (model made in {made:.1f} s; {r['frozen']} frozen leaves "
              f"bitwise unchanged, {quant}; every trainable leaf changed but "
              f"{len(r['exempt'])} whose last Adam step is below half a bf16 ulp of every "
              f"value, e.g. {r['exempt'][:3]}; hand-kernel launches {r['launches'] or 0}, "
              f"exactly as expected): " + _train_line(r, flops, TRAIN_SEQ, smi), flush=True)
        numbers[key] = {**r, "tflop": flops["total"] / 1e12}
        if bits == 4:
            numbers["int4_head_dx"] = hd = _int4_head_dx(model, TRAIN_SEQ)
            b = numbers["stage1"]
            print(f"[11 train] (e) against (b): step {r['ms']:.1f} / {b['ms']:.1f} ms device "
                  f"({r['ms'] / b['ms']:.3f}x), {r['host_ms']:.1f} / {b['host_ms']:.1f} ms host "
                  f"({r['host_ms'] / b['host_ms']:.3f}x), peak {r['peak_gb']:.2f} / "
                  f"{b['peak_gb']:.2f} GB ({r['peak_gb'] - b['peak_gb']:+.2f}); B3 under "
                  f"autograd at the head's shape (T {TRAIN_SEQ}, 4096 -> 49958, fp32 out): dX "
                  f"through Int4MatmulFn against int4_matmul_grad_ref max |err| "
                  f"{hd['err']:.3e} (tol {B3_TOL} of the largest), forward {hd['fwd_ms']:.3f} "
                  f"ms, backward (dequantize + cuBLAS) {hd['ms']:.3f} ms against a bound of "
                  f"{hd['bound_ms']:.3f} ms ({hd['bound_by']}); card {smi}", flush=True)
        del model
        gc.collect()
        torch.cuda.empty_cache()
    e = _int4_card_vs_cpu()
    print(f"[11 train] (e) tiny fp32 stage-1 step over an int4 text tower, card (B3's "
          f"{sorted(e['launches'])}) against CPU (plain version): loss {e['loss'][0]:.7f} / "
          f"{e['loss'][1]:.7f}, grad_norm {e['grad_norm'][0]:.7f} / {e['grad_norm'][1]:.7f}, "
          f"{e['n']} gradients within {e['worst']:.2e} of the largest (tolerances loss, "
          f"grad_norm, gradient {INT4_TRAIN_TOL}: B3 rounds x to bf16)", flush=True)
    c = _card_vs_cpu()
    print(f"[11 train] (c) tiny fp32 stage-2 step, card against CPU (TF32 off): loss "
          f"{c['loss'][0]:.7f} / {c['loss'][1]:.7f}, grad_norm {c['grad_norm'][0]:.7f} / "
          f"{c['grad_norm'][1]:.7f}, {c['n']} updated parameters within {c['worst']:.2e} "
          f"(rtol {TRAIN_RTOL}, atol {TRAIN_ATOL})", flush=True)
    d = _cli_end_to_end(tokenizer, smi)
    print(f"[11 train] (d) run_training.main on the card (tiny checkpoint, hidden 512, the "
          f"run's tokenizer, 4 records: 2 .npy images, a caption, a text-only): 3 steps with "
          f"--save_every 2 --remat in {d['seconds']:.1f} s; resumed from step_2, its adapter "
          f"within {d['resume_diff']:.2e}; the merged output through the factory, a greedy "
          f"chat ({d['reply_chars']} chars); the adapter folded by the unmerged loader, "
          f"logits within {d['fold_diff']:.2e} of the bf16 merged output's; card {smi}",
          flush=True)
    return numbers


# ---------------------------------------------------------------------------
# phase 13: serving over a device mesh (torch.distributed, NCCL)
# ---------------------------------------------------------------------------

MESH_TP = (2, 4, 8)  # the TP degrees whose one-rank shard shapes phase 13 (d) runs
CP_PROMPT = 2048  # phase 13 (e): the context-parallel prefill's prompt
MESH_NOTE = ("a one-rank shard shape of a TP = {nm} 7B (this card runs world size 1): "
             "launches are one op-level pass ({what}); the time predicts a rank's device "
             "time under TP, not a multi-card run")


def _copy_model(model, cfg, dtype=torch.bfloat16, text_layers=None):
    """A new VisualCLAModel on the card with ``model``'s weights (the first
    ``text_layers`` text layers of them, in ``dtype``)."""
    if text_layers is not None:
        cfg = dataclasses.replace(cfg, text_config=dataclasses.replace(
            cfg.text_config, num_hidden_layers=text_layers))
    new = VisualCLAModel(cfg, device="cuda", dtype=dtype)
    src = model.state_dict()
    new.load_state_dict({k: src[k] for k in new.state_dict()})
    return new, cfg


def _collectives_line(calls: dict) -> str:
    return ", ".join(f"{k} {v}" for k, v in calls.items() if v)


def _collective_events(prof) -> dict:
    """The device events of a profile that a one-rank NCCL collective can be:
    device-to-device copies (``memcpy32_post`` in a replayed graph, ``Memcpy
    DtoD`` eagerly) and NCCL kernels, by name."""
    out = {}
    for e in prof.key_averages():
        low = e.key.lower()
        if e.device_type != torch.autograd.DeviceType.CUDA or e.key.startswith("nccl:"):
            continue  # nccl:* on the device is the host's annotation, not work
        if ("memcpy" in low and "dtoh" not in low and "htod" not in low) or "nccl" in low:
            out[e.key] = out.get(e.key, 0) + e.count
    return out


def _nccl_trace(meshed, plain, input_ids, pv) -> dict:
    """One short greedy generate (its graphs captured already) profiled on
    the meshed bundle and on the unmeshed one: the collectives issued
    (``tp.CALLS``: a replayed graph adds what its capture issued), the graph
    launches, and the device events that the collectives add to the same
    work (a one-rank gather is a device-to-device copy, a one-rank in-place
    sum nothing).  A replayed graph runs its copies as kernels or on the
    copy engine, under other names, so the totals are compared."""
    gen = SamplingConfig.greedy(max_new_tokens=9)
    found = {}
    for name, bundle in (("meshed", meshed), ("plain", plain)):
        bundle.generate(input_ids, pixel_values=pv, generation_config=gen)  # captured already
        torch.cuda.synchronize()
        calls0 = dict(tp_mod.CALLS)
        passes0 = dict(bundle.engine.counts)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            bundle.generate(input_ids, pixel_values=pv, generation_config=gen)
            torch.cuda.synchronize()
        found[name] = {
            "calls": {k: tp_mod.CALLS[k] - calls0[k] for k in calls0},
            "passes": {k: bundle.engine.counts[k] - passes0[k] for k in passes0},
            "events": _collective_events(prof),
            "graph_launches": sum(e.count for e in prof.key_averages()
                                  if e.key == "cudaGraphLaunch")}
    m, p = found["meshed"], found["plain"]
    added = sum(m["events"].values()) - sum(p["events"].values())
    return {"calls": m["calls"], "passes": m["passes"], "graph_launches": m["graph_launches"],
            "plain_calls": p["calls"], "events": m["events"], "plain_events": p["events"],
            "added": added}


def _row_window_check(meshed, plain, input_ids, pv) -> dict:
    """A data rank's sampled call (``global_rows``: row 1 of a 2-row batch's
    noise, baked into the captured start and decode) and unsplit calls of
    the same local B = 1 on the meshed engine, unsplit / split / unsplit,
    each equal to the unmeshed engine's eager call of the same kind (eager:
    a graph that ignored the window would make its two calls alike)."""
    one = SamplingConfig(max_new_tokens=16)  # sampled, the reference's defaults

    def run(bundle, split):
        with (global_rows(2, 1) if split else contextlib.nullcontext()):
            return bundle.generate(input_ids, pixel_values=pv, generation_config=one,
                                   seed=5).tolist()

    with graphs_mod.eager():
        want = {split: run(plain, split) for split in (False, True)}
    got = [(split, run(meshed, split)) for split in (False, True, False)]
    if any(ids != want[split] for split, ids in got):
        raise RuntimeError(f"row window: meshed {got} vs unmeshed {want}")
    a, b = want[False][0], want[True][0]
    return {"tokens": len(b), "differ": sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))}


def _mesh_pool(model, cfg, tokenizer, reqs, mesh, kv_quant: str) -> dict:
    """``reqs`` on a 4-row paged pool, a first run capturing the graphs, then
    the counted run: its ids, B4's launches against one a layer per decode
    pass, the device ms a pass."""
    eng = paged_mod.PagedServingEngine(
        model, cfg, eos_token_id=tokenizer.eos_token_id, pad_token_id=tokenizer.pad_token_id,
        pool_size=4, block_size=64, num_blocks=160, max_seq_len=2048, max_new_tokens_cap=32,
        prompt_buckets=(128, 256, 512, 1024), sampling=SamplingConfig.greedy(32),
        kv_quant=kv_quant, mesh=mesh)
    _pool_run(eng, reqs, None, 24, spec=False, eager=False)  # captures
    _reset_counters()
    _reset_passes(eng)
    run = _pool_run(eng, reqs, None, 24, spec=False, eager=False)
    counts = _counters()
    b4 = "paged_append_kv8" if kv_quant == "int8" else "paged_append"
    L = cfg.text_config.num_hidden_layers
    if counts[b4] != L * eng.counts["decode_passes"] or eng.counts["decode_passes"] == 0:
        raise RuntimeError(f"meshed pool ({kv_quant}): {b4} launched {counts[b4]} times for "
                           f"{eng.counts['decode_passes']} decode passes of {L} layers")
    run["b4"] = counts[b4]
    del eng
    torch.cuda.empty_cache()
    return run


def _mesh_contiguous(model, cfg, tokenizer, reqs, mesh) -> dict:
    """``reqs`` on a 4-row contiguous ``ServingEngine(mesh=)`` through direct
    ``_pool_run`` calls (a first run capturing the graphs, then the counted
    run): its ids, B1's and B2's launches against one a layer a decode /
    prefill pass, the device ms a pass."""
    eng = server_mod.ServingEngine(
        model, cfg, eos_token_id=tokenizer.eos_token_id, pad_token_id=tokenizer.pad_token_id,
        pool_size=4, max_seq_len=2048, max_new_tokens_cap=32,
        sampling=SamplingConfig.greedy(32), mesh=mesh)
    _pool_run(eng, reqs, None, 24, spec=False, eager=False)  # captures
    _reset_counters()
    _reset_passes(eng)
    run = _pool_run(eng, reqs, None, 24, spec=False, eager=False)
    L = cfg.text_config.num_hidden_layers
    _check_counts(_counters(), {"flash_prefill": L * eng.counts["prefill_passes"],
                                "flash_decode": L * eng.counts["decode_passes"]})
    run["b1"] = L * eng.counts["decode_passes"]
    run["b2"] = L * eng.counts["prefill_passes"]
    del eng
    torch.cuda.empty_cache()
    return run


SCHED_NEW_TOKENS = 24  # phase 13 (f)'s sequential requests


def _http_round(worker, overrides, L: int, paged: bool) -> dict:
    """8 concurrent /chat_stream requests through the HTTP handler on
    ``worker``: every one answered, exact launches (B2 once a layer an
    admission or chunk; B1 or B4 once a layer a decode pass, B5 once a layer
    a speculative one), TTFT and the aggregate rate on the host clock."""
    engine, sched = worker.engine, worker.scheduler
    server = ThreadingHTTPServer(("127.0.0.1", 0), serve_app.make_handler(worker))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    gc_ = {**overrides, "max_new_tokens": SERVE_NEW_TOKENS}
    records = [{} for _ in range(8)]
    torch.cuda.synchronize()
    _reset_counters()
    _reset_passes(engine)
    stats0 = sched.stats()
    t0 = time.perf_counter()
    _run_all([lambda i=i: _http(port, "/chat_stream", {
        "text": PROMPT, "generation_config": gc_,
        "image_b64": _npy_b64(random_image(SEED + 20 + i))}, records[i]) for i in range(8)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, stats1 = _counters(), sched.stats()
    server.shutdown()
    server.server_close()
    for i, r in enumerate(records):
        res = r.get("result")
        if res is None or not isinstance(res.get("response"), str) or not r.get("partials"):
            raise RuntimeError(f"PoolWorker(paged={paged}) HTTP request {i}: {r}")
    admissions = stats1["prefills"] - stats0["prefills"]
    if paged:
        _check_serve_counts(engine, stats0, stats1, counts, L, "paged_append_kv8",
                            "paged_verify_kv8")
        used = {k: counts[k] for k in ("flash_prefill", "paged_append_kv8", "paged_verify_kv8")}
    else:
        passes = engine.counts
        if admissions != 8 or passes["prefill_passes"] != admissions:
            raise RuntimeError(f"{admissions} admissions in {passes['prefill_passes']} prefill "
                               "passes (an admission captured inside the round?)")
        _check_counts(counts, {"flash_prefill": L * passes["prefill_passes"],
                               "flash_decode": L * passes["decode_passes"]})
        used = {"flash_prefill": counts["flash_prefill"],
                "flash_decode_pool": counts["flash_decode"]}
    ttfts = sorted((r["t_first"] - r["t0"]) * 1e3 for r in records)
    tokens = sum(r["partials"] for r in records)
    return {"launches": used, "wall": wall, "tok_s": tokens / wall, "tokens": tokens,
            "ttft_p50": statistics.median(ttfts), "ttft_max": ttfts[-1],
            "admissions": admissions, "chunked": stats1["chunked_admissions"]
            - stats0["chunked_admissions"]}


def _scheduler_mesh(b13, bundle, cfg, tokenizer, reqs, smi) -> dict:
    """Phase 13 (f): a meshed model served through the normal entry point,
    ``PoolWorker`` -> ``Scheduler`` -> each pool (contiguous, and paged with
    int8 KV speculating at ``spec_k`` SPEC_K) over the (1, 1) mesh, and the
    same on the unmeshed bundle: ``reqs`` one at a time, each alone in its
    pool, the meshed ids equal to the unmeshed; then ``_http_round`` on each
    worker; and the contiguous pool by direct calls over the mesh against
    the unmeshed pool.  -> {kernel: launches} of the meshed runs."""
    L = cfg.text_config.num_hidden_layers
    launches, lines = {}, []
    for paged in (False, True):
        kw = dict(pool_size=4, max_new_tokens_cap=SERVE_KW["max_new_tokens_cap"])
        if paged:
            kw.update(paged=True, kv_quant="int8", spec_k=SPEC_K)
        over = SPEC_GREEDY if paged else GREEDY_OVERRIDES
        ids, rounds = {}, {}
        for name, b in (("meshed", b13), ("plain", bundle)):
            worker = serve_app.PoolWorker(b, **kw)
            if (worker.engine.mesh is None) != (name == "plain"):
                raise RuntimeError(f"PoolWorker built its {name} pool with mesh "
                                   f"{worker.engine.mesh}")
            ids[name] = [server_mod.generate_sync(worker.scheduler, *req,
                                                  max_new_tokens=SCHED_NEW_TOKENS,
                                                  sampling_overrides=over).tolist()
                         for req in reqs]
            rounds[name] = _http_round(worker, over, L, paged)
            worker.close()
            del worker
            gc.collect()
            torch.cuda.empty_cache()
        if ids["meshed"] != ids["plain"]:
            raise RuntimeError(f"meshed PoolWorker(paged={paged}) ids {ids['meshed']} != "
                               f"unmeshed {ids['plain']}")
        for k, v in rounds["meshed"]["launches"].items():
            launches[k] = launches.get(k, 0) + v
        m, p = rounds["meshed"], rounds["plain"]
        lines.append(
            (f"paged int8 KV, spec_k {SPEC_K}" if paged else "contiguous")
            + f": {len(reqs)} sequential requests x {SCHED_NEW_TOKENS} new, ids equal the "
            f"unmeshed PoolWorker's; 8 concurrent /chat_stream x {SERVE_NEW_TOKENS} new, all "
            f"answered: meshed {m['wall']:.2f} s, {m['tok_s']:.1f} tok/s aggregate, TTFT p50 "
            f"{m['ttft_p50']:.1f} ms, max {m['ttft_max']:.1f} ms vs unmeshed {p['wall']:.2f} "
            f"s, {p['tok_s']:.1f} tok/s, {p['ttft_p50']:.1f} / {p['ttft_max']:.1f} ms (host "
            f"clock, {m['tokens']} tokens streamed); meshed {m['admissions']} one-shot and "
            f"{m['chunked']} chunked admissions, launches {m['launches']} (exact: "
            + ("B2 = 32 x prefills and chunks, B4 = 32 x decode passes, B5 = 32 x speculative "
               "passes" if paged else "B2 = 32 x prefill passes, B1 = 32 x decode passes")
            + ")")
    meshed = _mesh_contiguous(b13.model, cfg, tokenizer, reqs, b13.mesh)
    plain = _mesh_contiguous(bundle.model, cfg, tokenizer, reqs, None)
    if meshed["ids"] != plain["ids"]:
        raise RuntimeError(f"meshed contiguous pool ids {meshed['ids']} != unmeshed "
                           f"{plain['ids']}")
    launches["flash_decode_pool"] += meshed["b1"]
    launches["flash_prefill"] += meshed["b2"]
    print(f"[13 mesh] (f) PoolWorker over the (1, 1) mesh -> Scheduler -> pool (world size "
          f"1: the Scheduler drives the pool itself, no message); {'; '.join(lines)}; the "
          f"concurrent ids are not compared: admission timing changes the batch and bf16 "
          f"batching is not bitwise; ServingEngine(mesh=) by direct calls, 4 rows x 24 new: "
          f"ids equal the unmeshed pool's, B1 {meshed['b1']} and B2 {meshed['b2']} launches "
          f"(one a layer a decode / prefill pass), device {meshed['pass_ms']:.3f} ms a pass "
          f"meshed vs {plain['pass_ms']:.3f} unmeshed; world size > 1 is the CPU tests' "
          f"(NCCL refuses two ranks on one device); card {smi}", flush=True)
    return launches


def _mesh_flash_cases(gen, nm, prompt_bucket, rows, failures, mesh) -> list:
    """B1 and B2 at 32/nm heads over 32 layers (the main path's shapes), and
    B2u's mesh form at 32/nm heads (bnsh, causal, B 2, Sq 512, S 2048) as the
    model reaches it: ``cached_attention`` over one layer's K/V under
    ``mesh``'s scope (``_flash_sharded``: B2u and its two gathers)."""
    N, lines = 32 // nm, []
    for kind, B, Sq in (("prefill", 1, prompt_bucket), ("decode", 1, 1)):
        name = f"flash_{kind}_tp{nm}"
        q, kc, vc, valid, slot = _kernel_case(kind, B, Sq, N, N, gen, L=32,
                                              slot0=prompt_bucket + 16)
        err, ok = _against_plain(kind, q, kc, vc, valid, slot, 7)
        wrapper, plain = _wrapper_and_plain(kind)
        L = kc.shape[0]
        fa.reset_launch_counts()
        for layer in range(L):
            wrapper(q, kc, vc, valid, slot, layer)
        torch.cuda.synchronize()
        rows[name] = {
            "launches": fa.LAUNCHES["flash_" + kind], "max_abs_err": err,
            "ms": device_ms(lambda i: wrapper(q, kc, vc, valid, slot, i % L), calls=L),
            "plain_ms": device_ms(lambda i: plain(q, kc, vc, valid, slot, i % L), calls=L),
            **_flash_bound_and_library(kind, q, kc, vc, valid, slot, {}),
            "note": MESH_NOTE.format(nm=nm, what="32 layers")}
        lines.append(f"{kind} N{N} err={err:.2e} {rows[name]['ms'] * 1e3:.1f}us")
        if not ok:
            failures.append(f"{name} err={err:.2e}")
        del q, kc, vc
    dev = "cuda"
    L, B, Sq, S = 32, 2, 512, 2048
    slot = torch.tensor([100, 1000], dtype=torch.int32, device=dev)
    valid = torch.arange(S, device=dev)[None, :] < slot[:, None].long() + Sq
    valid[0, :7], valid[1, :300] = False, False
    q = torch.randn(B, Sq, N, 128, generator=gen, device=dev).to(torch.bfloat16)
    kc, vc = (torch.randn(L, B, N, S, 128, generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(2))
    def mesh_form(q, k, v, valid, slot, **kw):
        with attention_mesh_scope(mesh):
            return cached_attention(q, k, v, valid, slot)

    err, ok = _b2u_check(q, kc[7], vc[7], valid, slot, True, "bnsh", {}, fn=mesh_form)
    fa.reset_launch_counts()
    gathers = tp_mod.CALLS["all_gather"]
    for layer in range(L):
        mesh_form(q, kc[layer], vc[layer], valid, slot)
    torch.cuda.synchronize()
    if fa.LAUNCHES["flash_full"] != L or tp_mod.CALLS["all_gather"] - gathers != 2 * L:
        failures.append(f"mesh form tp{nm}: {fa.LAUNCHES['flash_full']} B2u launches and "
                        f"{tp_mod.CALLS['all_gather'] - gathers} gathers over {L} layers")
    b_ms, b_by = _b2u_bound(q, kc[7], valid, slot, True, "bnsh", {})
    q_slot = slot.long()[:, None] + torch.arange(Sq, device=dev)[None, :]
    mask = (valid[:, None, :] & (torch.arange(S, device=dev)[None, None, :]
                                 <= q_slot[:, :, None]))[:, None]
    qt = q.transpose(1, 2)
    name = f"flash_full_mesh_tp{nm}"
    rows[name] = {
        "launches": fa.LAUNCHES["flash_full"], "max_abs_err": err,
        "ms": device_ms(lambda i: mesh_form(q, kc[i % L], vc[i % L], valid, slot), calls=L),
        "plain_ms": device_ms(lambda i: fa.flash_attention_ref(q, kc[i % L], vc[i % L], valid,
                                                               slot, kv_layout="bnsh"), calls=2),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": device_ms(lambda i: F.scaled_dot_product_attention(
            qt, kc[i % L], vc[i % L], attn_mask=mask), calls=L),
        "note": MESH_NOTE.format(nm=nm, what="32 layers") + (
            "; through _flash_sharded on a (1, 1) mesh: B2u and its two one-rank gathers")}
    lines.append(f"mesh form N{N} err={err:.2e} {rows[name]['ms'] * 1e3:.1f}us")
    if not ok:
        failures.append(f"{name} err={err:.2e}")
    del q, kc, vc
    return lines


def _mesh_vit_case(gen, nm, rows, failures) -> str:
    """The ViT's attention at 16/nm heads of hd 64 (257 tokens, causal off,
    B 1), over its 24 layers."""
    N, L, S, dev = 16 // nm, 24, 257, "cuda"
    q, k, v = (torch.randn(L, 1, S, N, 64, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    valid = torch.ones(1, S, dtype=torch.bool, device=dev)
    slot = torch.zeros(1, dtype=torch.int32, device=dev)
    err, ok = _b2u_check(q[7], k[7], v[7], valid, slot, False, "bsnh", {})
    fa.reset_launch_counts()
    for layer in range(L):
        fa.flash_attention(q[layer], k[layer], v[layer], valid, 0, causal=False)
    torch.cuda.synchronize()
    b_ms, b_by = _b2u_bound(q[7], k[7], valid, slot, False, "bsnh", {})
    name = f"flash_full_vit_tp{nm}"
    qt, kt, vt_ = (t.transpose(2, 3) for t in (q, k, v))
    rows[name] = {
        "launches": fa.LAUNCHES["flash_full"], "max_abs_err": err,
        "ms": device_ms(lambda i: fa.flash_attention(q[i % L], k[i % L], v[i % L], valid, 0,
                                                     causal=False), calls=L),
        "plain_ms": device_ms(lambda i: fa.flash_attention_ref(q[i % L], k[i % L], v[i % L],
                                                               valid, 0, causal=False), calls=2),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": device_ms(lambda i: F.scaled_dot_product_attention(
            qt[i % L], kt[i % L], vt_[i % L]), calls=L),
        "note": MESH_NOTE.format(nm=nm, what="the ViT's 24 layers")}
    if not ok:
        failures.append(f"{name} err={err:.2e}")
    return f"ViT N{N} hd64 err={err:.2e} {rows[name]['ms'] * 1e3:.1f}us"


def _tp_int4_shapes(nm: int) -> dict:
    """One rank's int4 carriers, (in, out), under TP = nm at the 7B shapes:
    column shards (q/k/v/gate/up: out/nm) and row shards (o/down: G/nm whole
    groups of 128), each leaf whole where ``_valid_spec`` says its axis does
    not divide (down's 86 groups at nm 4 and 8, the head's 49958 columns at
    nm 4 and 8)."""
    out = {}
    for name, (i, o) in {**LAYER_SHAPES, "lm_head": HEAD_SHAPE}.items():
        if name in ("o_proj", "down_proj"):
            G = i // 128
            out[name] = (i // nm, o) if G % nm == 0 else (i, o)
        else:
            out[name] = (i, o // nm) if o % nm == 0 else (i, o)
    return out


def _mesh_b3_cases(gen, nm, rows, failures) -> str:
    """B3 on one rank's carriers: both forms at 1 and 512 tokens on every
    local shape against the plain version; the decode form's row timed at
    T 1 and the prefill form's at T 512, per call over one decoder layer's
    seven matmuls."""
    shapes = _tp_int4_shapes(nm)
    weights = {n: _b3_weight(gen, *s) for n, s in shapes.items()}
    cells, worst = [], {"decode": 0.0, "prefill": 0.0}
    for n, (q, s) in weights.items():
        in_dim, out = shapes[n]
        out_dtype = torch.float32 if n == "lm_head" else torch.bfloat16
        for T in (1, 512):
            x = torch.randn(T, in_dim, generator=gen, device="cuda").to(torch.bfloat16)
            for form in i4.FORMS:
                err, ok = _b3_check(x, q, s, out_dtype, form=form)
                worst[form] = max(worst[form], err)
                if not ok:
                    failures.append(f"int4_matmul_{form}_tp{nm} ({in_dim},{out}) T{T} "
                                    f"err={err:.2e}")
        cells.append(f"{n} ({in_dim},{out})")
    layer = [weights[n] for n in LAYER_SHAPES]
    for form, T in (("decode", 1), ("prefill", 512)):
        xs = {}
        for q, _ in layer:
            k = 2 * q.shape[0] * q.shape[1]
            xs.setdefault(k, torch.randn(T, k, generator=gen, device="cuda").to(torch.bfloat16))

        def run(i, fn=None):
            for q, s in layer:
                x = xs[2 * q.shape[0] * q.shape[1]]
                fn(x, q, s) if fn else i4._launch(x, q, s, torch.bfloat16, form=form)

        i4.reset_launch_counts()
        run(0)
        torch.cuda.synchronize()
        launches = i4.LAUNCHES["int4_matmul_" + form]
        ms = device_ms(lambda i: run(i), calls=2) / len(layer)
        plain_ms = device_ms(lambda i: run(i, i4.int4_matmul_ref), calls=2) / len(layer)
        dense = [dequantize_grouped(q, s, torch.bfloat16) for q, s in layer]
        lib_ms = device_ms(lambda i: [xs[w.shape[0]] @ w for w in dense], calls=2) / len(layer)
        del dense
        moved = sum(nbytes(q, s) + T * 2 * (2 * q.shape[0] * q.shape[1] + q.shape[2])
                    for q, s in layer) / len(layer)
        ops = sum(2 * T * 2 * q.shape[0] * q.shape[1] * q.shape[2] for q, _ in layer) / len(layer)
        b_ms, b_by = bound(moved, ops)
        rows[f"int4_matmul_{form}_tp{nm}"] = {
            "launches": launches, "max_abs_err": worst[form], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "note": MESH_NOTE.format(nm=nm, what=f"one decoder layer's 7 local matmuls at T {T}")}
    return ("B3 " + ", ".join(cells) + f" err decode {worst['decode']:.2e} prefill "
            f"{worst['prefill']:.2e}; per call {rows[f'int4_matmul_decode_tp{nm}']['ms'] * 1e3:.1f}"
            f"us (T1) / {rows[f'int4_matmul_prefill_tp{nm}']['ms'] * 1e3:.1f}us (T512)")


def _mesh_b4_case(nm, rows, failures) -> str:
    """B4 at 32/nm heads: the main path's B=4 ragged rows, bf16 pool, over 32
    layers."""
    N = 32 // nm
    case = paged_case([320, 383, 330, -1], N, N, L=32, layer=7, dtype=torch.bfloat16,
                      device="cuda", seed=SEED + nm)
    err, ok = _paged_check(pa.paged_append_attention, pa.paged_append_attention_ref, case,
                           slice(None))
    L = case["k_pool"].shape[0]
    pa.reset_launch_counts()
    for layer in range(L):
        pa.paged_append_attention(**{**case, "layer": layer})
    torch.cuda.synchronize()
    b_ms, b_by = bound(*_b4_case_bytes(case))
    name = f"paged_append_tp{nm}"
    rows[name] = {
        "launches": pa.LAUNCHES["paged_append"], "max_abs_err": err,
        "ms": device_ms(lambda i: pa.paged_append_attention(**{**case, "layer": i % L}),
                        calls=L),
        "plain_ms": device_ms(lambda i: pa.paged_append_attention_ref(
            **{**case, "layer": i % L}), calls=2),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "note": MESH_NOTE.format(nm=nm, what="32 layers")}
    if not ok:
        failures.append(f"{name} err={err:.2e}")
    del case
    torch.cuda.empty_cache()
    return f"B4 N{N} err={err:.2e} {rows[name]['ms'] * 1e3:.1f}us"


def _mesh_kernels(prompt_bucket: int, mesh) -> dict:
    """Phase 13 (d): every kernel of the meshed path at the shard shapes of
    one rank of a TP = 2, 4 and 8 7B, against its plain version (B2u's mesh
    form under ``mesh``'s scope)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    rows, failures, lines = {}, [], []
    for nm in MESH_TP:
        parts = _mesh_flash_cases(gen, nm, prompt_bucket, rows, failures, mesh)
        parts.append(_mesh_vit_case(gen, nm, rows, failures))
        parts.append(_mesh_b3_cases(gen, nm, rows, failures))
        parts.append(_mesh_b4_case(nm, rows, failures))
        lines.append(f"TP{nm}: " + "; ".join(parts))
        torch.cuda.empty_cache()
    if failures:
        raise RuntimeError(f"shard-shape kernels disagree with their plain versions: {failures}")
    print(f"[13 mesh] (d) one rank's shard shapes, tol atol=rtol={ATOL} (B3 {B3_TOL}): "
          + " | ".join(lines), flush=True)
    return rows


def _ring_check(cfg, model, tokenizer, cp, want_tol=ATOL) -> dict:
    """Phase 13 (e): a ('data', 'seq') = (1, 1) mesh, the context-parallel
    prefill of a 2048-token prompt: run eagerly (``graphs.eager()``) with each
    layer's ring output held against B2's on the same q, k, v, then captured
    (the ids equal the eager run's)."""
    eng = Engine(model, cfg, eos_token_id=tokenizer.eos_token_id,
                 pad_token_id=tokenizer.pad_token_id, max_seq_len=2048, mesh=cp)
    ids = np.random.default_rng(SEED + 13).integers(
        10, cfg.text_config.vocab_size - 10, (1, CP_PROMPT))
    errs, ring_fn = [], llama_mod.ring_attention
    sampling = SamplingConfig.greedy(max_new_tokens=8)

    def checked(q, k, v, q_pos, kv_pos, valid, ring, **kw):
        out = ring_fn(q, k, v, q_pos, kv_pos, valid, ring, **kw)
        kc, vc = (t.transpose(1, 2).contiguous()[None] for t in (k, v))
        ref = fa.flash_prefill_stacked(q, kc, vc, valid, 0, 0)
        err = (out.float() - ref.float()).abs()
        if not bool((err <= want_tol + want_tol * ref.float().abs()).all()):
            raise RuntimeError(f"ring layer {len(errs)}: ring vs B2 max err {err.max().item()}")
        errs.append(err.max().item())
        return out

    llama_mod.ring_attention = checked
    try:
        with graphs_mod.eager():
            eager = eng.generate(ids, sampling=sampling)
    finally:
        llama_mod.ring_attention = ring_fn
    calls0 = dict(tp_mod.CALLS)
    eng.generate(ids, sampling=sampling)  # captures
    t0 = time.perf_counter()
    out = eng.generate(ids, sampling=sampling)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    calls = {k: tp_mod.CALLS[k] - calls0[k] for k in calls0}
    if (len(errs) != cfg.text_config.num_hidden_layers or out.tolist() != eager.tolist()
            or not np.isfinite(out).all()):
        raise RuntimeError(f"ring prefill: {len(errs)} ring layers, captured ids "
                           f"{out.tolist()} vs eager {eager.tolist()}")
    return {"max_err": max(errs), "layers": len(errs), "ids": out, "s": secs, "prompt": ids,
            "calls": calls}


def phase_mesh(smi: str, cfg, tokenizer, sl: dict, prompt_bucket: int) -> dict:
    """Phase 13: the meshed path at world size 1 over NCCL at full width."""
    L = cfg.text_config.num_hidden_layers
    bundle = sl["bundle"]  # phase 4's, unmeshed
    store = tempfile.mkdtemp()
    distributed.initialize("cuda", init_method=f"file://{store}/store", world_size=1, rank=0)
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    mesh = make_mesh(1, 1)
    if dist.get_backend() != "nccl":
        raise RuntimeError(f"the mesh runs on {dist.get_backend()}, not NCCL")
    t0 = time.perf_counter()
    model13, _ = _copy_model(bundle.model, cfg)
    b13 = api.VisualCLA(model13, cfg, tokenizer, bundle.image_processor, max_seq_len=2048,
                        mesh=mesh)
    shard_s = time.perf_counter() - t0
    image = random_image(SEED)
    greedy = SamplingConfig.greedy(max_new_tokens=32)
    enc = encoding_text([], PROMPT, b13.num_patch, tokenizer)
    pv = b13.image_processor(image)["pixel_values"]
    t_first = time.perf_counter()
    for _ in api.chat_in_stream(b13, image, PROMPT, [], greedy, verbose=False):
        ttft_first = time.perf_counter() - t_first
        break
    torch.cuda.synchronize()
    calls0 = dict(tp_mod.CALLS)
    response, counts, passes = _counted_chat(b13, image, greedy)
    chat_calls = {k: tp_mod.CALLS[k] - calls0[k] for k in calls0}
    _check_counts(counts, {"flash_prefill": L, "flash_decode": L * passes["decode_passes"]})
    want, _ = api.chat(bundle, image, PROMPT, [], greedy, verbose=False)
    if response != want:
        raise RuntimeError(f"meshed chat {response!r} != phase 4's {want!r}")
    ids = b13.generate(enc["input_ids"], pixel_values=pv, generation_config=greedy)[0]
    if ids.tolist() != sl["ids"].tolist():
        raise RuntimeError(f"meshed greedy ids {ids.tolist()} != phase 4's {sl['ids'].tolist()}")
    ttft, rate = _streams(b13, image, greedy, response, enc["input_ids"], pv, ids)
    spec = b13.generate(enc["input_ids"], pixel_values=pv, generation_config=greedy,
                        speculative=True)[0]
    spec4 = bundle.generate(enc["input_ids"], pixel_values=pv, generation_config=greedy,
                            speculative=True)[0]
    if spec.tolist() != spec4.tolist():
        raise RuntimeError(f"meshed speculative ids {spec.tolist()} != phase 4's "
                           f"{spec4.tolist()}")
    bc = _beam_config()
    beam = b13.generate(enc["input_ids"], pixel_values=pv, generation_config=bc)
    beam4 = bundle.generate(enc["input_ids"], pixel_values=pv, generation_config=bc)
    if beam.tolist() != beam4.tolist():
        raise RuntimeError(f"meshed {BEAMS}-beam ids {beam.tolist()} != phase 4b's "
                           f"{beam4.tolist()}")
    trace = _nccl_trace(b13, bundle, enc["input_ids"], pv)
    if (trace["calls"]["all_reduce"] == 0 or trace["graph_launches"] == 0
            or trace["calls"]["all_gather"] == 0
            or trace["added"] < trace["calls"]["all_gather"]):
        raise RuntimeError(f"the replayed graphs lack the NCCL collectives' device work: "
                           f"{trace}")
    window = _row_window_check(b13, bundle, enc["input_ids"], pv)
    # device ms a decode step, the meshed and the unmeshed engine alternated
    pos = img_marker_positions(enc["input_ids"], tokenizer.img_start_token_id)
    steps = {"meshed": [], "plain": []}
    for _ in range(2):
        for name, eng in (("meshed", b13.engine), ("plain", bundle.engine)):
            steps[name].append(_decode_loop(eng, enc["input_ids"], pv, pos, greedy)["step_ms"])
    print(f"[13 mesh] (a, b) torch.distributed NCCL, world size 1 (a file store), mesh "
          f"(data 1, model 1); phase 4's bf16 7B copied and sharded in {shard_s:.1f} s; greedy "
          f"chat, generate ids ({len(ids)}), chat_in_stream, speculative ({len(spec)} ids) and "
          f"{BEAMS}-beam ids bitwise phase 4's; chat launches {counts} ({passes['decode_passes']} "
          f"decode passes), collectives a chat {_collectives_line(chat_calls)}; TTFT "
          f"{ttft * 1e3:.1f} ms warm (phase 4: {sl['ttft_ms']:.1f}), first chat "
          f"{ttft_first * 1e3:.1f} ms (its captures); B=1 decode {rate:.1f} tok/s (phase 4: "
          f"{sl['decode_tok_s']:.1f}); device ms a decode step (CUDA events on the replays, "
          f"alternated) {', '.join(f'{x:.3f}' for x in steps['meshed'])} meshed vs "
          f"{', '.join(f'{x:.3f}' for x in steps['plain'])} unmeshed; a profiled 9-token "
          f"generate: collectives "
          f"{_collectives_line(trace['calls'])} over {trace['passes']} passes, "
          f"{trace['graph_launches']} graph launches; device copies and NCCL kernels "
          f"{trace['events']} against the unmeshed run's {trace['plain_events']}: the "
          f"collectives add {trace['added']} events, at least one for each of the "
          f"{trace['calls']['all_gather']} gathers (NCCL runs a one-rank gather as a "
          f"device-to-device copy and a one-rank in-place sum as nothing); a data rank's "
          f"sampled row window (row 1 of 2: {window['tokens']} tokens, {window['differ']} of "
          f"them unlike the unsplit call's) keys its own graphs: unsplit, split and unsplit "
          f"calls on one engine each equal the unmeshed engine's; card {smi}", flush=True)
    pools = {}
    reqs = [_chat_request(bundle, tokenizer, image)]  # the chat turn and three text prompts
    reqs += [(np.asarray(tokenizer.encode(t), np.int64), None, None)
             for t in ("你好，请介绍一下你自己。", "图片里有什么？", "abc 123, hello!")]
    for kv_quant in ("none", "int8"):
        meshed = _mesh_pool(model13, cfg, tokenizer, reqs, mesh, kv_quant)
        plain = _mesh_pool(bundle.model, cfg, tokenizer, reqs, None, kv_quant)
        if meshed["ids"] != plain["ids"]:
            raise RuntimeError(f"meshed {kv_quant} pool ids {meshed['ids']} != unmeshed "
                               f"{plain['ids']}")
        pools[kv_quant] = (meshed, plain)
    print("[13 mesh] (c) PagedServingEngine(mesh=), 4 rows, ids equal the unmeshed pool's: "
          + "; ".join(f"{'int8' if k == 'int8' else 'bf16'} pool B4 {m['b4']} launches "
                      f"(one a layer a decode pass), device {m['pass_ms']:.3f} ms a pass "
                      f"meshed vs {p['pass_ms']:.3f} unmeshed"
                      for k, (m, p) in pools.items()) + f"; card {smi}", flush=True)
    sched_launches = _scheduler_mesh(b13, bundle, cfg, tokenizer, reqs, smi)
    del b13, model13
    gc.collect()
    torch.cuda.empty_cache()
    rows = _mesh_kernels(prompt_bucket, mesh)
    cp = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "seq"))
    model_cp, _ = _copy_model(bundle.model, cfg)
    ring = _ring_check(cfg, model_cp, tokenizer, cp)
    del model_cp
    torch.cuda.empty_cache()
    # fp32, 2 text layers: the ring path's ids equal the unmeshed engine's
    plain32, cfg2 = _copy_model(bundle.model, cfg, torch.float32, text_layers=2)
    want32 = Engine(plain32, cfg2, eos_token_id=tokenizer.eos_token_id,
                    pad_token_id=tokenizer.pad_token_id, max_seq_len=2048).generate(
        ring["prompt"], sampling=SamplingConfig.greedy(max_new_tokens=8))
    del plain32
    cp32, _ = _copy_model(bundle.model, cfg, torch.float32, text_layers=2)
    got32 = _ring_check(cfg2, cp32, tokenizer, cp, want_tol=F32_TOL)
    del cp32
    torch.cuda.empty_cache()
    if got32["ids"].tolist() != want32.tolist():
        raise RuntimeError(f"fp32 CP ids {got32['ids'].tolist()} != unmeshed {want32.tolist()}")
    print(f"[13 mesh] (e) ('data', 'seq') = (1, 1) mesh, a {CP_PROMPT}-token prompt: the "
          f"ring prefill on all {ring['layers']} layers within atol=rtol={ATOL} of B2 on the "
          f"same q/k/v (max err {ring['max_err']:.2e}), captured ids equal the eager run's, "
          f"generate (8 tokens) {ring['s']:.3f} s warm, collectives of two captured runs "
          f"{_collectives_line(ring['calls'])}; fp32 "
          f"2-layer copy: ring within {F32_TOL} of B2 (max err {got32['max_err']:.2e}) and ids "
          f"equal the unmeshed engine's; card {smi}", flush=True)
    dist.destroy_process_group()
    return {"rows": rows, "ttft_ms": ttft * 1e3, "decode_tok_s": rate, "counts": counts,
            "scheduler_launches": sched_launches}


# ---------------------------------------------------------------------------
# phase 14: training over a device mesh (torch.distributed, NCCL, world size 1)
# ---------------------------------------------------------------------------

PIPE_PREFILL, PIPE_DECODE, PIPE_SMAX = 512, 16, 1024  # phase 14 (a)
# (b): the meshed step against the unmeshed one, bf16 at world size 1 (the
# loss and the clip's norm sum their pieces in another grouping)
MESH_TRAIN_RTOL = 2e-3
# (c): n_micro 2 runs each microbatch's bf16 products on one row (cuBLAS
# rounds by shape) against the unmeshed step's two rows
PIPE_TRAIN_RTOL = 2e-2


def _cached_passes(text, tc, embeds, kv_quant, mesh=None, M=1):
    """A PIPE_PREFILL-token prefill then PIPE_DECODE one-token steps of
    ``text`` over its own cache (``parallel.pipeline`` over ``mesh`` with
    ``M`` microbatches, else ``Llama.forward``) -> each pass's hidden
    states, the cache, each pass's kernel launches and device ms."""
    from visualcla_tpu_torch.parallel import pipeline as pp

    B, S0 = embeds.shape[0], PIPE_PREFILL
    if mesh is None:
        cache = llama_mod.init_kv_cache(tc, B, PIPE_SMAX, torch.bfloat16, device="cuda",
                                        kv_quant=kv_quant)
    else:
        cache = pp.pipeline_kv_cache(tc, B, PIPE_SMAX, torch.bfloat16, mesh, kv_quant=kv_quant)
    valid = torch.zeros(B, PIPE_SMAX, dtype=torch.bool, device="cuda")
    valid[:, :S0] = True
    hs, counts, ms = [], [], []
    steps = [(embeds[:, :S0], torch.arange(S0, device="cuda")[None].expand(B, S0), valid, 0)]
    for t in range(PIPE_DECODE):
        valid = valid.clone()
        valid[:, S0 + t] = True
        steps.append((embeds[:, S0 + t:S0 + t + 1],
                      torch.full((B, 1), S0 + t, device="cuda"), valid, S0 + t))
    with torch.no_grad():
        for e, pos, v, slot in steps:
            fa.reset_launch_counts()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            if mesh is None:
                h, _ = text(e, pos, cache, v, slot)
            else:
                h, _ = pp.pipeline_forward(text, tc, e, pos, cache, v, slot, mesh, n_micro=M)
            b.record()
            torch.cuda.synchronize()
            hs.append(h)
            counts.append({k: n for k, n in fa.LAUNCHES.items() if n})
            ms.append(a.elapsed_time(b))
    return hs, cache, counts, ms


def _pipeline_cached(cfg, smi: str) -> dict:
    """(a): the pipeline's cached form at M = 1 and 2, bf16 and int8 caches."""
    from visualcla_tpu_torch.parallel import pipeline as pp

    tc = cfg.text_config
    L = tc.num_hidden_layers
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    text = init_random_(llama_mod.Llama(tc, device="cuda", dtype=torch.bfloat16), gen)
    mesh = pp.make_pipe_mesh(1, 1)
    pp.shard_text_params(text, mesh)
    ids = torch.randint(5, tc.vocab_size, (2, PIPE_PREFILL + PIPE_DECODE), generator=gen,
                        device="cuda")
    with torch.no_grad():
        embeds = text.embed(ids)
    launches, lines = {}, []
    for kv in ("none", "int8"):
        suffix = "_kv8" if kv == "int8" else ""
        for M in (1, 2):
            hp, cp, np_, msp = _cached_passes(text, tc, embeds, kv, mesh, M)
            if M == 1:
                hw, cw, nw, msw = _cached_passes(text, tc, embeds, kv)
            else:  # each row alone: the microbatches' own shapes
                rows = [_cached_passes(text, tc, embeds[r:r + 1], kv) for r in range(2)]
                hw = [torch.cat([rows[0][0][i], rows[1][0][i]]) for i in range(len(rows[0][0]))]
                cw = {k: torch.cat([rows[0][1][k], rows[1][1][k]], dim=1) for k in rows[0][1]}
                msw = [rows[0][3][i] + rows[1][3][i] for i in range(len(rows[0][3]))]
            for i, (a, b) in enumerate(zip(hp, hw)):
                if not torch.equal(a, b):
                    raise RuntimeError(f"(a) {kv} cache, M={M}: pass {i}'s hidden states differ "
                                       f"from the unmeshed run's by "
                                       f"{float((a.float() - b.float()).abs().max()):.3e}")
            for k in cw:
                if not torch.equal(cp[k], cw[k]):
                    raise RuntimeError(f"(a) {kv} cache, M={M}: the cache's {k} differs")
            want = [{f"flash_prefill{suffix}": L * M}] + [{f"flash_decode{suffix}": L * M}] * \
                PIPE_DECODE
            if np_ != want:
                raise RuntimeError(f"(a) {kv} cache, M={M}: launches {np_[:2]}..., expected "
                                   f"{want[:2]}...")
            for name in (f"flash_prefill{suffix}", f"flash_decode{suffix}"):
                launches[name] = launches.get(name, 0) + sum(n.get(name, 0) for n in np_)
            # the times from a second run of each, warm, the unmeshed first
            if M == 1:
                msw = _cached_passes(text, tc, embeds, kv)[3]
            else:
                rows = [_cached_passes(text, tc, embeds[r:r + 1], kv)[3] for r in range(2)]
                msw = [a + b for a, b in zip(*rows)]
            msp = _cached_passes(text, tc, embeds, kv, mesh, M)[3]
            lines.append(f"{'int8' if kv == 'int8' else 'bf16'} cache M={M}: prefill "
                         f"{msp[0]:.3f} ms vs {msw[0]:.3f} unmeshed"
                         f"{'' if M == 1 else ' (two B=1 runs)'}, decode step p50 "
                         f"{statistics.median(msp[1:]):.3f} vs {statistics.median(msw[1:]):.3f}")
    print(f"[14 mesh train] (a) parallel.pipeline over (pipe 1, data 1), NCCL world size 1: a "
          f"seeded bf16 {L}-layer 7B text tower, B=2, a {PIPE_PREFILL}-token prefill then "
          f"{PIPE_DECODE} decode steps; M=1 bitwise Llama.forward and M=2 bitwise two B=1 runs "
          f"(hidden states every pass, the whole cache), exactly {L} x M B2 launches a prefill and "
          f"{L} x M B1 launches a step; device ms a pass (CUDA events over the eager passes of "
          f"a second, warm run of each): " + "; ".join(lines) + f"; card {smi}", flush=True)
    del text
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _mesh_step(model, cfg, batch, pipeline_mesh=None, steps: int = 2) -> dict:
    """``steps`` stage-2 subset steps (constant lr TRAIN_LR, remat; over
    ``pipeline_mesh`` with n_micro 2 when given): the first step's loss and
    grad_norm (the same initial state as the unmeshed step's), the last
    step's host and device ms, collectives and hand-kernel launches, and the
    peak memory of the steps over what was allocated before them."""
    from visualcla_tpu_torch.train.lora import lora_trainable
    from visualcla_tpu_torch.train.trainer import (init_train_state, make_optimizer,
                                                   make_train_step_subset, partition_params)

    opt = make_optimizer(learning_rate=TRAIN_LR, schedule="const")
    train, frozen = partition_params(model, lora_trainable)
    state = init_train_state(train, opt)
    step = make_train_step_subset(model, cfg, opt, lora_trainable, remat=True,
                                  pipeline_mesh=pipeline_mesh, n_micro=2)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    first = None
    for i in range(steps):
        calls0 = dict(tp_mod.CALLS)
        _reset_counters()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        state, m = step(state, frozen, batch)
        b.record()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3
        if first is None:
            first = (float(m["loss"]), float(m["grad_norm"]))
    launches = {k: v for k, v in _counters().items() if v}
    if launches:
        raise RuntimeError(f"the training step launched hand kernels: {launches}")
    if not all(np.isfinite(first)):
        raise RuntimeError(f"non-finite loss or grad_norm {first}")
    return {"loss": first[0], "grad_norm": first[1], "host_ms": host, "ms": a.elapsed_time(b),
            "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
            "calls": {k: tp_mod.CALLS[k] - calls0[k] for k in calls0}}


def _mesh_train_steps(cfg, tokenizer, smi: str, phase11: dict) -> None:
    """(b) and (c): the 7B QLoRA step unmeshed, on a (data 1, model 1) mesh
    as is and with FSDP, and over a (pipe 1, data 1) pipeline at B = 2."""
    from visualcla_tpu_torch.fixtures import train_batch, train_model
    from visualcla_tpu_torch.parallel import pipeline as pp
    from visualcla_tpu_torch.parallel.sharding import shard_params

    b1 = train_batch(cfg, tokenizer)
    b2 = {k: np.concatenate([v, train_batch(cfg, tokenizer, seed=SEED + 1)[k]])
          for k, v in b1.items()}
    runs = {}
    for name, batch, kind in (("unmeshed", b1, None), ("mesh", b1, "tp"), ("fsdp", b1, "fsdp"),
                              ("unmeshed B=2", b2, None), ("pipeline", b2, "pipe")):
        model = train_model(cfg, 2)
        pipe = None
        if kind in ("tp", "fsdp"):
            shard_params(model, make_mesh(1, 1), fsdp=kind == "fsdp")
        elif kind == "pipe":
            pipe = pp.make_pipe_mesh(1, 1)
            pp.shard_text_params(model, pipe)
        runs[name] = _mesh_step(model, cfg, batch, pipe)
        del model
        gc.collect()
        torch.cuda.empty_cache()
    first11 = phase11["stage2"]["losses"][0]
    checks = [("unmeshed", "phase 11's first step", runs["unmeshed"]["loss"], first11,
               MESH_TRAIN_RTOL)]
    for name, ref, tol in (("mesh", "unmeshed", MESH_TRAIN_RTOL),
                           ("fsdp", "unmeshed", MESH_TRAIN_RTOL),
                           ("pipeline", "unmeshed B=2", PIPE_TRAIN_RTOL)):
        for key in ("loss", "grad_norm"):
            checks.append((f"{name} {key}", ref, runs[name][key], runs[ref][key], tol))
    for what, ref, got, want, tol in checks:
        if not abs(got - want) <= tol * abs(want):
            raise RuntimeError(f"(b/c) {what} {got} vs the {ref} {want} (rtol {tol})")

    def line(name):
        r = runs[name]
        return (f"{name}: loss {r['loss']:.6f}, grad_norm {r['grad_norm']:.6f}, step "
                f"{r['ms']:.1f} ms device / {r['host_ms']:.1f} ms host, peak +{r['peak_gb']:.2f} "
                f"GB, collectives a step {_collectives_line(r['calls']) or 'none'}")

    print(f"[14 mesh train] (b) the 7B QLoRA stage-2 step (phase 11 (a)'s model, seed and "
          f"batch, B=1 S={b1['input_ids'].shape[1]}, remat, lr {TRAIN_LR}) on a (data 1, model "
          f"1) NCCL mesh, LoRA over the TP layers, as is and with fsdp=True, the first step's "
          f"loss and grad_norm within rtol {MESH_TRAIN_RTOL} of the unmeshed step's (which is "
          f"phase 11's first loss {first11:.6f}); the second step timed: "
          + "; ".join(line(n) for n in ("unmeshed", "mesh", "fsdp")) + f"; card {smi}",
          flush=True)
    print(f"[14 mesh train] (c) the same step over parallel.pipeline (pipe 1, data 1), "
          f"n_micro 2, B=2, within rtol {PIPE_TRAIN_RTOL} of the unmeshed B=2 step: "
          + "; ".join(line(n) for n in ("unmeshed B=2", "pipeline")) + f"; card {smi}",
          flush=True)


def phase_mesh_train(smi: str, cfg, tokenizer, phase11: dict) -> dict:
    """Phase 14: training over a mesh at world size 1 over NCCL."""
    import torch.distributed as dist

    store = tempfile.mkdtemp()
    distributed.initialize("cuda", init_method=f"file://{store}/store", world_size=1, rank=0)
    if dist.get_backend() != "nccl":
        raise RuntimeError(f"the mesh runs on {dist.get_backend()}, not NCCL")
    launches = _pipeline_cached(cfg, smi)
    _mesh_train_steps(cfg, tokenizer, smi, phase11)
    dist.destroy_process_group()
    return launches


# -- phase 15: a Jamba text tower (kernels B7 and B8, the paged pool) ------------------

# one MoE layer and one Mamba layer of the Jamba cell (AI21-Jamba2-Mini)
JAMBA_H, JAMBA_I, JAMBA_E, JAMBA_D, JAMBA_N = 4096, 14336, 16, 8192, 16
# B7 written in f32 sums the plain version's exact-nibble products in another
# order (the mma's); B8 computes in f32 from bf16 inputs as its plain version
# does: bf16 outputs within one rounding of the largest, f32 states within
# 1e-4 of theirs (exp and softplus differ by ulps)
B7_TOL, B8_TOL, B8_STATE_TOL = 1e-4, 2e-2, 1e-4
JAMBA_SOURCE = {"moe_int4_matmul": "visualcla_tpu_torch/csrc/moe_int4.cu",
                "selective_scan": "visualcla_tpu_torch/csrc/selective_scan.cu"}


def _b7_layer(gen):
    """One MoE layer's experts at the int4 tier: (gate/up, down) stacked
    carriers and scales."""
    def stacked(K, Nout):
        parts = [quantize_grouped((torch.randn(K, Nout, generator=gen, device="cuda") * 0.02)
                                  .to(torch.bfloat16), group=128) for _ in range(JAMBA_E)]
        return (torch.stack([p["q"] for p in parts]).contiguous(),
                torch.stack([p["scale"] for p in parts]).contiguous())

    return stacked(JAMBA_H, 2 * JAMBA_I), stacked(JAMBA_I, JAMBA_H)


def _b7_check(x, q, s, offs, T, label, failures) -> float:
    """B7 against its plain version on the routed rows (f32 within B7_TOL of
    the largest; the bf16 form the MoE runs equal to the f32 one rounded).
    -> the worst error over the largest."""
    n = int(offs[-1])
    got = b7.moe_int4_matmul(x, q, s, offs, T, out_dtype=torch.float32)[:n]
    want = b7.moe_int4_matmul_ref(x, q, s, offs, out_dtype=torch.float32)[:n]
    bf = b7.moe_int4_matmul(x, q, s, offs, T)[:n]
    err = float((got - want).abs().max() / want.abs().max())
    if not err <= B7_TOL or not torch.equal(bf, got.to(torch.bfloat16)):
        failures.append(f"B7 {label}: error {err:.2e} of the largest (limit {B7_TOL}), bf16 "
                        f"form equal to the f32 one rounded: {torch.equal(bf, got.to(bf.dtype))}")
    return err


def _b7_cases(gen, failures) -> list:
    """B7 at the Jamba cell's shapes: a 32-row decode pass with 32, 14 (the
    cell's mean) and 8 rows running, the others routed to no expert as the
    MoE routes them; admission chunks of 256 tokens, all real and 120 real
    (a 376-token prompt's second chunk).  The routing uniform at random;
    four layers' carriers in turn for the times, so no call finds its
    expert in L2."""
    layers = [_b7_layer(gen) for _ in range(4)]
    H, I, k = JAMBA_H, JAMBA_I, 2
    expert_bytes = H * 2 * I // 2 + (H // 128) * 2 * I * 4 + I * H // 2 + (I // 128) * H * 4
    rows = []
    for name, T, n_live in (("decode 32 rows, 32 running", 32, 32),
                            ("decode 32 rows, 14 running", 32, 14),
                            ("decode 32 rows, 8 running", 32, 8),
                            ("chunk 256", 256, 256), ("chunk 256, 120 real", 256, 120)):
        live = (torch.arange(T, device="cuda") < n_live)[:, None]
        idx = torch.rand(T, JAMBA_E, generator=gen, device="cuda").topk(k, dim=-1).indices
        order, offs, counts = jamba_mod.dispatch(torch.where(live, idx, JAMBA_E), JAMBA_E + 1)
        offs, hit = offs[:JAMBA_E + 1].contiguous(), int((counts[:JAMBA_E] > 0).sum())
        A, n = T * k, n_live * k
        x = (torch.randn(A, H, generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
        h = (torch.randn(A, I, generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
        (gq, gs), (dq, ds) = layers[0]
        err = max(_b7_check(x, gq, gs, offs, T, name + " gate/up", failures),
                  _b7_check(h, dq, ds, offs, T, name + " down", failures))
        card = (device_ms(lambda i: b7.moe_int4_matmul(x, *layers[i % 4][0], offs, T))
                + device_ms(lambda i: b7.moe_int4_matmul(h, *layers[i % 4][1], offs, T)))
        plain = event_ms(lambda: b7.moe_int4_matmul_ref(
            F.silu(b7.moe_int4_matmul_ref(x, gq, gs, offs)[:, :I]), dq, ds, offs), n=1)
        least, by = bound(hit * expert_bytes + n * (2 * (H + 2 * I) + 2 * (I + H)),
                          n * 2.0 * 3 * H * I)
        rows.append({"kernel": "B7", "case": name, "assignments": n, "experts_hit": hit,
                     "card_us": card * 1e3, "bound_us": least * 1e3, "bound_by": by,
                     "plain_us": plain * 1e3, "max_rel_err": err})
    return rows


def _b8_inputs(gen, B, W):
    D, N = JAMBA_D, JAMBA_N

    def r(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * std).to(torch.bfloat16)

    xz = r(B, W, 2 * D)
    dt = torch.exp(torch.rand(D, generator=gen, device="cuda") * math.log(100.0) + math.log(1e-3))
    return dict(x=xz[..., :D], z=xz[..., D:], w=r(D, 4, std=0.5), bias=r(D, std=0.1),
                dt=r(B, W, D, std=0.5), dt_bias=(dt + torch.log(-torch.expm1(-dt))).to(
                    torch.bfloat16),
                A_log=(torch.log(torch.arange(1, N + 1, device="cuda").float()).expand(D, N)
                       + torch.randn(D, N, generator=gen, device="cuda") * 0.1).to(torch.bfloat16),
                Bm=r(B, W, N), Cm=r(B, W, N), Dsk=r(D), conv=r(B, D, 3),
                ssm=torch.randn(B, D, N, generator=gen, device="cuda"))


def _b8_scan_args(i, at=slice(None)):
    return (i["dt"][:, at], i["dt_bias"], i["A_log"], i["Bm"][:, at], i["Cm"][:, at], i["Dsk"],
            i["z"][:, at])


def _b8_close(got, want, tol) -> float:
    return float((got.float().cpu() - want.float()).abs().max() / want.float().abs().max())


def _b8_cases(gen, failures) -> list:
    """B8 at one Mamba layer of the cell (D 8192, N 16): the chunk form at 256
    tokens (all real, 120 real), the step form over a 32-row pool with 32,
    14 and 8 rows running; outputs and states against the plain versions
    (run on CPU copies), the states of rows that do not run unchanged bit
    for bit."""
    D, N = JAMBA_D, JAMBA_N
    rows = []
    for name, n_real in (("chunk 256", 256), ("chunk 256, 120 real", 120)):
        i = _b8_inputs(gen, 1, 256)
        lens = torch.tensor([n_real], device="cuda")
        conv, ssm = i["conv"].clone(), i["ssm"].clone()
        u = b8.conv_chunk(i["x"], i["w"], i["bias"], conv, lens)
        y = b8.scan_chunk(u, *_b8_scan_args(i), ssm, lens)
        c = {k: v.cpu() for k, v in i.items()}
        conv_r, ssm_r = c["conv"].clone(), c["ssm"].clone()
        u_r = b8.conv_chunk_ref(c["x"], c["w"], c["bias"], conv_r, lens.cpu())
        y_r = b8.scan_ref(u.cpu(), *_b8_scan_args(c), ssm_r, lens.cpu())
        errs = (_b8_close(u[:, :n_real], u_r[:, :n_real], B8_TOL),
                _b8_close(y[:, :n_real], y_r[:, :n_real], B8_TOL),
                _b8_close(ssm, ssm_r, B8_STATE_TOL))
        if errs[0] > B8_TOL or errs[1] > B8_TOL or errs[2] > B8_STATE_TOL or \
                not torch.equal(conv.cpu(), conv_r):
            failures.append(f"B8 {name}: errors (conv out, scan out, ssm state) {errs}, conv "
                            f"state equal {torch.equal(conv.cpu(), conv_r)}")

        def chunk(_=0, i=i, lens=lens, fn=(b8.conv_chunk, b8.scan_chunk)):
            uu = fn[0](i["x"], i["w"], i["bias"], i["conv"], lens)
            return fn[1](uu, *_b8_scan_args(i), i["ssm"], lens)

        nb = n_real * (2 * 2 * D + 2 * (4 * D + 2 * N))
        least, by = bound(nb, n_real * (7.0 * D * N + 14 * D))
        rows.append({"kernel": "B8", "case": name, "card_us": device_ms(chunk) * 1e3,
                     "bound_us": least * 1e3, "bound_by": by, "max_rel_err": max(errs),
                     "plain_us": event_ms(lambda: chunk(fn=(b8.conv_chunk_ref, b8.scan_ref)),
                                          n=1) * 1e3})
    i = _b8_inputs(gen, 32, 1)
    for running in (32, 14, 8):
        run = torch.zeros(32, dtype=torch.bool, device="cuda")
        run[:running] = True
        conv, ssm = i["conv"].clone(), i["ssm"].clone()
        u = b8.conv_step(i["x"][:, 0], i["w"], i["bias"], conv, run)
        y = b8.scan_step(u, *_b8_scan_args(i, 0), ssm, run)
        c = {k: v.cpu() for k, v in i.items()}
        conv_r, ssm_r, r = c["conv"].clone(), c["ssm"].clone(), run.cpu()
        u_r = b8.conv_step_ref(c["x"][:, 0], c["w"], c["bias"], conv_r, r)
        y_r = b8.scan_step(u.cpu(), *_b8_scan_args(c, 0), ssm_r, r)
        errs = (_b8_close(u[run], u_r[r], B8_TOL), _b8_close(y[run], y_r[r], B8_TOL),
                _b8_close(ssm, ssm_r, B8_STATE_TOL))
        kept = torch.equal(conv[~run], i["conv"][~run]) and torch.equal(ssm[~run], i["ssm"][~run])
        if errs[0] > B8_TOL or errs[1] > B8_TOL or errs[2] > B8_STATE_TOL or not kept or \
                not torch.equal(conv.cpu(), conv_r):
            failures.append(f"B8 step, {running} of 32 running: errors {errs}, idle rows' "
                            f"states unchanged {kept}")

        def step(_=0, run=run):
            uu = b8.conv_step(i["x"][:, 0], i["w"], i["bias"], i["conv"], run)
            return b8.scan_step(uu, *_b8_scan_args(i, 0), i["ssm"], run)

        def plain_step(run=run):
            uu = b8.conv_step_ref(i["x"][:, 0], i["w"], i["bias"], i["conv"], run)
            return b8.scan_ref(uu[:, None], *_b8_scan_args(i, slice(0, 1)), i["ssm"], run)

        nb = running * (2 * 2 * D + 2 * (4 * D + 2 * N) + 2 * (D * N * 4 + D * 3 * 2))
        least, by = bound(nb, running * (7.0 * D * N + 14 * D))
        rows.append({"kernel": "B8", "case": f"step 32 rows, {running} running",
                     "card_us": device_ms(step) * 1e3, "bound_us": least * 1e3, "bound_by": by,
                     "max_rel_err": max(errs), "plain_us": event_ms(plain_step, n=1) * 1e3})
    return rows


def _jamba_pool_model(cfg):
    """VisualCLA-7B's vision side over a Jamba tower of the cell's layer
    pattern and heads at a small width: 8 layers (attention at 4, Mamba
    elsewhere; a 16-expert top-2 MoE in the odd layers), hidden 512 (4
    heads of 128, GQA 2), the 7B's vocabulary; seeded random bf16 weights
    quantized on the card to the int4 tier."""
    hf = dict(model_type="jamba", vocab_size=cfg.text_config.vocab_size, hidden_size=512,
              intermediate_size=256, num_hidden_layers=8, num_attention_heads=4,
              num_key_value_heads=2, attn_layer_period=8, attn_layer_offset=4,
              expert_layer_period=2, expert_layer_offset=1, num_experts=16,
              num_experts_per_tok=2, mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
              mamba_dt_rank="auto", mamba_conv_bias=True, mamba_proj_bias=False,
              rms_norm_eps=1e-6, tie_word_embeddings=False, hidden_act="silu")
    jcfg = dataclasses.replace(cfg, text_config=JambaConfig.from_hf_dict(hf))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = init_random_(VisualCLAModel(jcfg, device="cuda", dtype=torch.bfloat16), gen)
    quantize_text_tower_(model, 4)
    return model, jcfg


def _jamba_serve(cfg, tokenizer) -> dict:
    """The Jamba pool's own run: ``PoolWorker(paged=True)`` -> ``Scheduler``
    -> ``PagedServingEngine`` (8 rows, int8 K/V, chunks of 256), a warm-up
    request, then 6 concurrent chats with the counters zeroed just before
    them: every launch of B7, B8, B4, B2 and B3 against the engine's passes.
    -> the launches."""
    model, jcfg = _jamba_pool_model(cfg)
    tc = jcfg.text_config
    L_moe, L_mamba, L_attn = len(model.text.moe_index), tc.num_mamba_layers, tc.num_attention_layers
    bundle = api.VisualCLA(model, jcfg, tokenizer,
                           ImageProcessor(image_size=jcfg.vision_config.image_size),
                           max_seq_len=1024)
    worker = serve_app.PoolWorker(bundle, pool_size=8, paged=True, block_size=64, num_blocks=64,
                                  kv_quant="int8", max_new_tokens_cap=64)
    engine, sched = worker.engine, worker.scheduler
    reqs = [_chat_request(bundle, tokenizer, random_image(SEED + 90 + i),
                          text=PROMPT + " 请详细描述。" * (8 * i)) for i in range(6)]
    server_mod.generate_sync(sched, *reqs[0], max_new_tokens=4)  # warm-up: captures
    _reset_counters()
    _reset_passes(engine)
    stats0 = sched.stats()
    outs = [None] * len(reqs)

    def one(i):
        outs[i] = server_mod.generate_sync(sched, *reqs[i], max_new_tokens=24)

    _run_all([lambda i=i: one(i) for i in range(len(reqs))])
    torch.cuda.synchronize()
    counts, stats1 = _counters(), sched.stats()
    worker.close()
    dec, pre = engine.counts["decode_passes"], engine.counts["prefill_passes"]
    chunks = stats1["prefill_chunks"] - stats0["prefill_chunks"]
    expect = {"moe_int4_matmul": 2 * L_moe * (dec + pre),
              "selective_conv_step": L_mamba * dec, "selective_scan_step": L_mamba * dec,
              "selective_conv_chunk": L_mamba * pre, "selective_scan_chunk": L_mamba * pre,
              "paged_append_kv8": L_attn * dec, "flash_prefill": L_attn * pre,
              "paged_append": 0, "flash_decode": 0, "flash_prefill_kv8": 0}
    bad = {k: (counts[k], v) for k, v in expect.items() if counts[k] != v}
    if bad or dec == 0 or pre == 0 or any(o is None or len(o) == 0 for o in outs) or \
            counts["int4_matmul_decode"] == 0 or counts["int4_matmul_prefill"] == 0:
        raise RuntimeError(f"Jamba serve launches (got, expected): {bad}; passes "
                           f"{engine.counts}, chunked admissions' chunks {chunks}, B3 "
                           f"{counts['int4_matmul_decode']} / {counts['int4_matmul_prefill']}, "
                           f"outputs {[None if o is None else len(o) for o in outs]}")
    print(f"[15 jamba] pool run (PoolWorker(paged=True) -> Scheduler -> PagedServingEngine, "
          f"8 layers: {L_attn} attention, {L_mamba} Mamba, {L_moe} MoE of 16 experts): "
          f"{len(reqs)} chats, {dec} decode passes, {pre} tower passes ({chunks} chunks of "
          f"chunked admissions); launches exact: B7 {counts['moe_int4_matmul']}, B8 step "
          f"{counts['selective_scan_step']} + conv {counts['selective_conv_step']}, chunk "
          f"{counts['selective_scan_chunk']} + conv {counts['selective_conv_chunk']}, B4 int8 "
          f"{counts['paged_append_kv8']}, B2 {counts['flash_prefill']}; B3 decode "
          f"{counts['int4_matmul_decode']}, prefill {counts['int4_matmul_prefill']}; "
          f"moe_experts_hit {engine.counts['moe_experts_hit']}", flush=True)
    return {"moe_int4_matmul": counts["moe_int4_matmul"],
            "selective_scan": sum(counts[k] for k in b8.LAUNCHES)}


def phase_jamba(smi: str, cfg, tokenizer) -> dict:
    """B7 and B8 against their plain versions at the Jamba cell's shapes, with
    device times, bounds and plain times; then the Jamba pool's own run with
    exact launch counts.  -> the kernel summary's rows."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    failures: list = []
    cases = _b8_cases(gen, failures) + _b7_cases(gen, failures)
    for c in cases:
        print(json.dumps(c), flush=True)
    if failures:
        raise RuntimeError("; ".join(failures))
    gc.collect()
    torch.cuda.empty_cache()
    launches = _jamba_serve(cfg, tokenizer)
    print(f"[15 jamba] {smi}: B7 and B8 equal their plain versions at the cell's shapes "
          f"({len(cases)} cases)", flush=True)
    rows = []
    for name, kernel in (("moe_int4_matmul", "B7"), ("selective_scan", "B8")):
        mine = [c for c in cases if c["kernel"] == kernel]
        rows.append({"name": name, "route": "cuda", "source": JAMBA_SOURCE[name],
                     "replaces": None, "launches": launches[name],
                     "max_abs_err": max(c["max_rel_err"] for c in mine),
                     "cases": {c["case"]: {k: c[k] for k in ("card_us", "bound_us", "plain_us")}
                               for c in mine}})
    return {"rows": rows}


def _kernels_vs_plain_logits(engine, input_ids, pixel_values, img_pos):
    """Last-token prefill logits through the kernels and, on the same model,
    with the kernels' plain versions swapped in."""
    text = engine.model.text
    kernel = text.logits(_last_hidden(engine, input_ids, pixel_values, img_pos))
    with plain_kernels():
        plain = text.logits(_last_hidden(engine, input_ids, pixel_values, img_pos))
    return kernel, plain


def _last_hidden(engine, input_ids, pixel_values, img_pos):
    """Final-normed hidden state (B, 1, H) of each row's last prompt token
    after a prefill into a fresh 2048-slot cache."""
    hidden, *_ = engine.prefill(input_ids, pixel_values, img_pos, 2048)
    return hidden[:, -1:]


def _tokenizer_from_file(built):
    """Save the in-process tokenizer's model as ``tokenizer.model`` and read
    it back through ``VisualCLATokenizer.from_pretrained``, as the factory
    reads a checkpoint's: the same vocabulary and the same prompt ids, or the
    run fails.  -> the tokenizer read from the file."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tokenizer.model")
        built.sp.save(path)
        size = os.path.getsize(path)
        loaded = VisualCLATokenizer.from_pretrained(tmp)
    texts = (PROMPT, COPY_PROMPT, "abc 123, hello!\n图片里有什么？") + REPEAT_TEXTS
    if (loaded.sp != built.sp or len(loaded) != len(built)
            or any(loaded.encode(t) != built.encode(t) for t in texts)
            or loaded.eos_token_id != built.eos_token_id
            or loaded.img_start_token_id != built.img_start_token_id):
        raise RuntimeError("the tokenizer read back from tokenizer.model differs from the "
                           "one that was saved")
    print(f"[1 device] tokenizer.model written ({size} bytes, {len(built.sp.pieces)} pieces) "
          f"and read back through VisualCLATokenizer.from_pretrained in "
          f"{time.perf_counter() - t0:.2f} s: equal model, equal prompt ids", flush=True)
    return loaded


def main() -> int:
    t_start = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 1)
        return out

    info = phase_device()
    timed("2 build", phase_build)
    cfg = visualcla_config_for_size("7B")
    tokenizer = _tokenizer_from_file(make_tokenizer(cfg.text_config.vocab_size))
    prompt_len = len(encoding_text([], PROMPT, cfg.num_image_tokens, tokenizer)["input_ids"][0])
    kern = timed("3 kernels", phase_kernels, pick_bucket(PROMPT_BUCKETS, prompt_len), prompt_len)
    sl = timed("4 slice", phase_slice, info["smi"], cfg, tokenizer)
    launches = sl["launches"]
    beams = timed("4b beams", phase_beams, info["smi"], cfg, tokenizer, sl["bundle"])
    timed("4f concurrency", phase_concurrency, info["smi"], cfg, tokenizer, sl["bundle"])
    timed("12 apps", phase_apps, info["smi"], cfg, tokenizer, sl["bundle"], sl)
    mesh = timed("13 mesh", phase_mesh, info["smi"], cfg, tokenizer, sl,
                 pick_bucket(PROMPT_BUCKETS, prompt_len))
    vision = timed("4v vision", phase_vision, info["smi"], cfg, tokenizer, sl.pop("bundle"))
    launches4 = timed("5 int4", phase_int4, info["smi"], cfg, tokenizer)["launches"]
    timed("6 int8", phase_int8, info["smi"], cfg, tokenizer)
    serve = timed("7 serve", phase_serve, info["smi"], cfg, tokenizer)
    contiguous = timed("7c serve contiguous", phase_serve_contiguous, info["smi"], cfg,
                       tokenizer)
    serve4 = timed("8 serve int4", phase_serve_int4, info["smi"], cfg, tokenizer)
    timed("9 reference", phase_reference, info["smi"], cfg, tokenizer, sl["ids"])
    train = timed("11 train", phase_train, info["smi"], cfg, tokenizer)
    pipe_launches = timed("14 mesh train", phase_mesh_train, info["smi"], cfg, tokenizer, train)
    jamba = timed("15 jamba", phase_jamba, info["smi"], cfg, tokenizer)
    print(f"[10 time] seconds a phase {seconds}; the whole run "
          f"{time.perf_counter() - t_start:.1f} s after the imports", flush=True)
    # each kernel's launches from the run of the path that drives it
    runs = {"paged_append": serve["launches"], "paged_append_kv8": serve4["launches"],
            "paged_verify": serve["spec"]["launches"],
            "paged_verify_kv8": serve4["spec_launches"], "flash_full": vision["launches"],
            "flash_decode_beam4": {"flash_decode_beam4": beams["launches"]["flash_decode"]},
            "flash_decode_pool": {"flash_decode_pool": contiguous["launches"]["flash_decode"]}}
    notes = {"paged_decode": B6_NOTE, "paged_decode_kv8": B6_NOTE,
             "flash_full_kv8": B2U_KV8_NOTE}
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        if name in kern["op_launches"]:
            n = kern["op_launches"][name]
        elif name in runs:
            n = runs[name][name]
        elif name.endswith("_kv8") or name.startswith("int4"):
            n = launches4[name]
        else:
            n = launches[name]
        row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": n, "max_abs_err": kern["worst"][name], **kern["main"][name]}
        if name in notes:
            row["note"] = notes[name]
        if name in pipe_launches:  # phase 14 (a): the pipeline's cached form, a path of its own
            row["pipeline_launches"] = pipe_launches[name]
        if name in mesh["scheduler_launches"]:  # phase 13 (f): PoolWorker over the mesh
            row["scheduler_mesh_launches"] = mesh["scheduler_launches"][name]
        if name.startswith("int4"):  # phase 11 (e): stage 1 over the int4 tower
            row["train_launches"] = train["stage1_int4"]["launches"].get(name, 0)
        kernels.append(row)
    for name, r in mesh["rows"].items():  # phase 13 (d): one rank's shard shapes
        base = name.rsplit("_tp", 1)[0].replace("_mesh", "").replace("_vit", "")
        source, replaces = KERNELS[base]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        **r})
    kernels += jamba["rows"]  # phase 15: B7 and B8, launches from the Jamba pool's run
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
