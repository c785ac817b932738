"""Time the flash-attention kernels' tuning choices on the card, side by side
in one process:

    python -m visualcla_tpu_torch.ops.cuda.bench_flash [--ptxas] [--runs 128,256]

- B1 (split-KV decode) at the 7B heads over a 32-layer, 2048-slot cache: B = 1
  at slots 528 and 2040, B = 8 at ragged slots, bf16 and int8 K/V, for each
  ``--runs`` value (kv slots a block, a compile-time constant of the source:
  one build per value);
- B2 / B2u (tensor-core template) with each block tiling (``TILING`` 1: 64
  query rows, 2: 128 rows, 3: 64 rows with the kv axis split over two
  warpgroups) and what the wrapper picks: the chat prefill (Sq 512), the speculative verify
  (Sq 5 and 9), the ViT at 224 and 448 px (257 and 1025 tokens, hd 64), the
  resampler, and the mesh form (B = 2, Sq 512 at slots 100 / 1000), bf16 and
  int8 K/V;
- each beside ``scaled_dot_product_attention`` on the same inputs where it
  computes the same function, and with its max abs error against the plain
  version.
Times are device times from a CUDA graph of the calls replayed (launch gaps
excluded), the cache kernels over the 32 layers in turn.  ``--ptxas`` also
prints registers and spills of every kernel instance.  Needs a GPU and nvcc.
"""
from __future__ import annotations

import argparse
import re
import statistics
import subprocess
import sys
import tempfile

import torch
import torch.nn.functional as F

from . import build
from . import flash_attention as fa
from ..quantization import quantize_kv


def device_ms(fn, calls: int = 10, replays: int = 5) -> float:
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


def ptxas_report(name: str = "flash_attention") -> None:
    """Registers and spills of every kernel instance in ``csrc/<name>.cu``."""
    src = f"{build.CSRC}/{name}.cu"
    flags = [f for f in build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    with tempfile.NamedTemporaryFile(suffix=".cubin") as tmp:
        err = subprocess.run([build._nvcc_path(), *flags, "-Xptxas", "-v", "-cubin", "-o",
                              tmp.name, src], capture_output=True, text=True).stderr
    name = None
    for line in err.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            full = subprocess.run(["c++filt", m.group(1)], capture_output=True,
                                  text=True).stdout.strip() or m.group(1)
            short = re.search(r"(\w+<[^(]*>)\(", full)  # kernel<template arguments>
            name = short.group(1) if short else full
        elif "registers" in line or "spill" in line:
            regs = re.search(r"Used (\d+) registers", line)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if regs:
                print(f"[ptxas] {name}: {regs.group(1)} registers")
            if spill and spill.group(1) != "0":
                print(f"[ptxas] {name}: spills {spill.group(1)} B stored, {spill.group(2)} B loaded")
        elif "warning" in line or "error" in line or "Performance" in line:
            print(f"[ptxas] {line.strip()}")


def rebuild(run: int) -> None:
    """Load the library built with ``run`` kv slots a B1 block."""
    base = tuple(f for f in build.NVCC_FLAGS if not f.startswith("-DVCLA_DECODE_RUN"))
    build.NVCC_FLAGS = base + (f"-DVCLA_DECODE_RUN={run}",)
    build._LIBS.pop("flash_attention", None)
    fa._lib = None
    fa.build_kernels()


def rnd(gen, *shape, dtype=torch.bfloat16):
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


def err_vs_plain(out, ref) -> float:
    return (out.float() - ref.float()).abs().max().item()


def bench_decode(gen, run: int) -> None:
    L, N, S, hd = 32, 32, 2048, 128
    for label, slots in (("B1 slot 528", [528]), ("B1 slot 2040", [2040]),
                         ("B8 ragged", [272 + 131 * b for b in range(8)])):
        B = len(slots)
        q, kc, vc = rnd(gen, B, 1, N, hd), rnd(gen, L, B, N, S, hd), rnd(gen, L, B, N, S, hd)
        slot = torch.tensor(slots, dtype=torch.int32, device="cuda")
        valid = torch.arange(S, device="cuda")[None, :] <= slot[:, None].long()
        valid[:, :3] = False
        for kv8 in (False, True):
            k, v, sc = kc, vc, {}
            if kv8:
                (k, ks), (v, vs) = quantize_kv(kc), quantize_kv(vc)
                sc = {"k_scale": ks, "v_scale": vs}
            out = fa.flash_decode_stacked(q, k, v, valid, slot, 7, **sc)
            again = fa.flash_decode_stacked(q, k, v, valid, slot, 7, **sc)
            ref = fa.flash_decode_stacked_ref(q.float(), k if kv8 else k.float(),
                                              v if kv8 else v.float(), valid, slot, 7, **sc)
            ms = device_ms(lambda i: fa.flash_decode_stacked(q, k, v, valid, slot, i % L, **sc),
                           calls=L)
            lib = ""
            if not kv8 and B == 1:
                n_kv = slots[0] + 1
                qt, mask = q.transpose(1, 2), valid[:, None, None, :n_kv]
                lib_ms = device_ms(lambda i: F.scaled_dot_product_attention(
                    qt, k[i % L][:, :, :n_kv], v[i % L][:, :, :n_kv], attn_mask=mask), calls=L)
                lib = f", sdpa {lib_ms * 1e3:.1f}us"
            print(f"[decode run={run}] {label} {'int8' if kv8 else 'bf16'}: {ms * 1e3:.1f}us"
                  f"{lib}, err {err_vs_plain(out, ref):.2e}, bitwise repeat "
                  f"{torch.equal(out, again)}", flush=True)
        del q, kc, vc


TILINGS = {1: "64 rows", 2: "128 rows", 3: "kv split", None: "picked"}


def bench_template(gen) -> None:
    L, N, S = 32, 32, 2048
    kc, vc = rnd(gen, L, 2, N, S, 128), rnd(gen, L, 2, N, S, 128)
    (kq, ks), (vq, vs) = quantize_kv(kc), quantize_kv(vc)

    def cache_case(label, B, Sq, slots):
        q = rnd(gen, B, Sq, N, 128)
        slot = torch.tensor(slots, dtype=torch.int32, device="cuda")
        valid = torch.arange(S, device="cuda")[None, :] < slot[:, None].long() + Sq
        valid[:, :3] = False
        for kv8 in (False, True):
            k, v = (kq, vq) if kv8 else (kc, vc)
            k, v = k[:, :B], v[:, :B]
            sc = {"k_scale": ks[:, :B], "v_scale": vs[:, :B]} if kv8 else {}
            ref = fa.flash_prefill_stacked_ref(q.float(), k if kv8 else k.float(),
                                               v if kv8 else v.float(), valid, slot, 7, **sc)
            times = []
            for tiling in (1, 2, 3, None):
                fa.TILING = tiling
                out = fa.flash_prefill_stacked(q, k, v, valid, slot, 7, **sc)
                ms = device_ms(lambda i: fa.flash_prefill_stacked(q, k, v, valid, slot, i % L,
                                                                  **sc), calls=L)
                times.append(f"{TILINGS[tiling]} {ms * 1e3:.1f}us err "
                             f"{err_vs_plain(out, ref):.2e}")
            lib = ""
            if not kv8:
                qt = q.transpose(1, 2)
                q_slot = slot.long()[:, None] + torch.arange(Sq, device="cuda")[None, :]
                mask = (valid[:, None, :] & (torch.arange(S, device="cuda")[None, None, :]
                                             <= q_slot[:, :, None]))[:, None]
                lib_ms = device_ms(lambda i: F.scaled_dot_product_attention(
                    qt, k[i % L], v[i % L], attn_mask=mask), calls=L)
                lib = f", sdpa(mask) {lib_ms * 1e3:.1f}us"
            print(f"[template] {label} {'int8' if kv8 else 'bf16'}: " + "; ".join(times) + lib,
                  flush=True)

    cache_case("B2 prefill Sq512 slot 0", 1, 512, [0])
    cache_case("B2 verify Sq5 slot 600", 1, 5, [600])
    cache_case("B2 verify Sq9 slots 600/700", 2, 9, [600, 700])
    cache_case("mesh form B2 Sq512 slots 100/1000", 2, 512, [100, 1000])
    del kc, vc, kq, vq
    for label, B, Sq, Skv in (("ViT 224px", 1, 257, 257), ("ViT 224px", 8, 257, 257),
                              ("ViT 448px", 1, 1025, 1025), ("resampler", 1, 64, 321)):
        q, k, v = rnd(gen, B, Sq, 16, 64), rnd(gen, B, Skv, 16, 64), rnd(gen, B, Skv, 16, 64)
        valid = torch.ones(B, Skv, dtype=torch.bool, device="cuda")
        ref = fa.flash_attention_ref(q.float(), k.float(), v.float(), valid, 0, causal=False)
        times = []
        for tiling in (1, 2, 3, None):
            fa.TILING = tiling
            out = fa.flash_attention(q, k, v, valid, 0, causal=False)
            ms = device_ms(lambda i: fa.flash_attention(q, k, v, valid, 0, causal=False))
            times.append(f"{TILINGS[tiling]} {ms * 1e3:.1f}us err {err_vs_plain(out, ref):.2e}")
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        lib_ms = device_ms(lambda i: F.scaled_dot_product_attention(qt, kt, vt))
        print(f"[template] {label} B{B} bf16 hd64: " + "; ".join(times)
              + f", sdpa {lib_ms * 1e3:.1f}us", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--runs", default="128")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_flash: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    if args.ptxas:
        ptxas_report()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for run in (int(r) for r in args.runs.split(",")):
        rebuild(run)
        print(f"flash_attention.cu built in {build.build_seconds.get('flash_attention', 0):.1f} s "
              f"(VCLA_DECODE_RUN={run})", flush=True)
        bench_decode(gen, run)
    bench_template(gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
