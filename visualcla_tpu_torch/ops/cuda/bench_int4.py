"""Time the int4 matmul's (B3) two forms and prefill tilings on the card, side
by side in one process:

    python -m visualcla_tpu_torch.ops.cuda.bench_int4 [--ptxas] [--tokens 32,128,512]
        [--sweep 1,2,4,5,8,9,12,16,17,20,24,25,32,48,64,80,96,128,160,192,256]

- the prefill form (wgmma) at each block tiling (``PREFILL_TILES`` 1: 64
  tokens a block, 2: 128; both 128 columns wide) and at the one
  ``prefill_tiling`` picks, at the 7B text tower's seven matmul shapes (q/k/v/o
  4096 x 4096, gate/up 4096 x 11008, down 11008 x 4096; gs 128) for each
  ``--tokens`` count, beside a bf16 ``torch.matmul`` on the dequantized weight
  (the same function) and with the max error against the plain version
  relative to the output's largest value; the average over one decoder
  layer's seven calls in turn for each tiling;
- the decode form against the prefill form at each ``--sweep`` count on the
  7B and 13B shapes and their heads (f32 out), with the form ``decode_form``
  picks: the data its cost model is fitted to.  For each shape the points
  where the pick is the slower form, and B3's device time in one decode step
  of an 8-row pool (T = 8) and in one speculative chunk (T = 9) of 32 7B
  layers and the head, under ``decode_form`` and under a cut at a fixed T.
Times are device times from a CUDA graph of the calls replayed (launch gaps
excluded).  ``--ptxas`` also prints registers and spills of every kernel
instance.  Needs a GPU and nvcc.
"""
from __future__ import annotations

import argparse
import subprocess
import sys

import torch

from . import int4_matmul as i4
from .bench_flash import device_ms, ptxas_report
from ..quantization import dequantize_grouped, quantize_grouped

LAYER = {"q/k/v/o": (4096, 4096), "gate/up": (4096, 11008), "down": (11008, 4096)}
CALLS = {"q/k/v/o": 4, "gate/up": 2, "down": 1}  # calls of each shape in a decoder layer
HEAD = (4096, 49958)  # the 7B head (vocab 49958), written in f32
LAYERS = 32
SWEEP_SHAPES = {**{f"7B {k}": v for k, v in LAYER.items()}, "7B head": HEAD,
                "13B q/k/v/o": (5120, 5120), "13B gate/up": (5120, 13824),
                "13B down": (13824, 5120), "13B head": (5120, 49958)}
# token counts at which both forms are timed on the 7B shapes by chip_smoke.py:
# a plain decode step of an 8-row pool (8), a speculative chunk of spec_k 8
# (9), speculative pool steps of 1-4 rows at spec_k 4 (5-20), and either
# side of the decode form's 16-token tiles
CROSSOVER_TOKENS = (4, 5, 8, 9, 12, 16, 17, 20, 24, 32)


def weight(gen, in_dim, out):
    w = (torch.randn(in_dim, out, generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
    wq = quantize_grouped(w, group=128)
    return wq["q"], wq["scale"]


def rel_err(y, ref) -> float:
    return ((y.float() - ref).abs().max() / ref.abs().max()).item()


def prefill(x, q, s, tile):
    """The prefill form at ``tile`` (None: the one the wrapper picks).  A
    checkout older than ``_launch`` (the parent, unpacked by ``git archive``
    and timed beside this one) has only the wrapper, which picks the prefill
    form at ``--tokens``' counts."""
    if hasattr(i4, "_launch"):
        return i4._launch(x, q, s, form="prefill", tile=tile)
    return i4.int4_matmul(x, q, s)


def bench_tilings(gen, tokens) -> None:
    tilings = {**{t: f"t{t} {rows} tok" for t, rows in getattr(i4, "PREFILL_TILES", {}).items()},
               None: "picked"}
    weights = {name: weight(gen, *shape) for name, shape in LAYER.items()}
    for T in tokens:
        layer_ms = {t: 0.0 for t in tilings}
        lib_layer = 0.0
        for name, (q, s) in weights.items():
            in_dim = 2 * q.shape[0] * q.shape[1]
            x = torch.randn(T, in_dim, generator=gen, device="cuda").to(torch.bfloat16)
            ref = i4.int4_matmul_ref(x.float(), q, s)
            times = []
            for tile in tilings:
                run = lambda i, tile=tile: prefill(x, q, s, tile)
                err = rel_err(run(0), ref)
                ms = device_ms(run)
                layer_ms[tile] += CALLS[name] * ms
                times.append(f"{tilings[tile]} {ms * 1e3:.1f}us rel err {err:.1e}")
            dense = dequantize_grouped(q, s, torch.bfloat16)
            lib_ms = device_ms(lambda i: x @ dense)
            lib_layer += CALLS[name] * lib_ms
            del dense
            picked = (i4.prefill_tiling(T, q.shape[2], i4._sm_count(x.device))
                      if hasattr(i4, "prefill_tiling") else None)
            print(f"[prefill T{T}] {name} {LAYER[name]}: " + "; ".join(times)
                  + f"; bf16 matmul {lib_ms * 1e3:.1f}us (picks tiling {picked})", flush=True)
        n = sum(CALLS.values())
        print(f"[prefill T{T}] one decoder layer, average a call: "
              + "; ".join(f"{tilings[t]} {layer_ms[t] / n * 1e3:.1f}us" for t in tilings)
              + f"; bf16 matmul {lib_layer / n * 1e3:.1f}us", flush=True)


def sweep_forms(gen, tokens) -> dict:
    """{shape name: {T: (decode ms, prefill ms)}}, each form checked against
    the plain version; prints a line a shape."""
    sms = i4._sm_count(torch.device("cuda"))
    times = {}
    for name, (in_dim, out) in SWEEP_SHAPES.items():
        q, s = weight(gen, in_dim, out)
        out_dtype = torch.float32 if name.endswith("head") else torch.bfloat16
        times[name], cells, worst = {}, [], 0.0
        for T in tokens:
            x = torch.randn(T, in_dim, generator=gen, device="cuda").to(torch.bfloat16)
            ref = i4.int4_matmul_ref(x.float(), q, s)
            t = []
            for form in i4.FORMS:
                run = lambda i, form=form: i4._launch(x, q, s, out_dtype, form=form)
                worst = max(worst, rel_err(run(0), ref))
                t.append(device_ms(run))
            times[name][T] = tuple(t)
            pick = "decode" if i4.decode_form(T, in_dim, out, sms) else "prefill"
            slower = t[i4.FORMS.index(pick)] > min(t)
            cells.append(f"T{T} {t[0] * 1e3:.1f}/{t[1] * 1e3:.1f}{' ' + pick[0] if slower else ''}")
        print(f"[sweep] {name} ({in_dim},{out}) decode/prefill us ('d'/'p': decode_form picks "
              f"the slower, that one): " + "; ".join(cells) + f"; max rel err {worst:.1e}",
              flush=True)
        del q, s
        torch.cuda.empty_cache()
    return times


def step_b3_ms(times, T, rule) -> float:
    """B3's device time in one pass of 32 7B decoder layers and the head at
    T tokens, the form of each call chosen by ``rule(name, T, out)`` (True:
    decode), from the sweep's times."""
    total = 0.0
    for name, (_, out) in {**{f"7B {k}": v for k, v in LAYER.items()}, "7B head": HEAD}.items():
        calls = 1 if name.endswith("head") else LAYERS * CALLS[name[3:]]
        dec, pre = times[name][T]
        total += calls * (dec if rule(name, T, out) else pre)
    return total


def report_steps(times, tokens) -> None:
    sms = i4._sm_count(torch.device("cuda"))
    rules = {"decode_form": lambda name, T, out: i4.decode_form(
                 T, {**{f"7B {k}": v for k, v in LAYER.items()}, "7B head": HEAD}[name][0], out,
                 sms),
             "decode up to T=24": lambda name, T, out: T <= 24,
             "decode up to T=4": lambda name, T, out: T <= 4,
             "the faster form of each shape": lambda name, T, out: (times[name][T][0]
                                                                    <= times[name][T][1])}
    for T, what in ((8, "a decode step of an 8-row pool"), (9, "a speculative chunk (spec_k 8)"),
                    (20, "a speculative step of a 4-row pool (spec_k 4)")):
        if T in tokens:
            print(f"[steps] B3 in {what}, T={T}, 32 7B layers + head: " + "; ".join(
                f"{label} {step_b3_ms(times, T, rule):.3f} ms" for label, rule in rules.items()),
                flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--tokens", default="32,128,512")
    ap.add_argument("--sweep", default="1,2,4,5,8,9,12,16,17,20,24,25,32,48,64,80,96,128,160,192,"
                                       "256")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_int4: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    if args.ptxas:
        ptxas_report("int4_matmul")
    i4.build_kernels()
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.tokens:
        bench_tilings(gen, [int(t) for t in args.tokens.split(",")])
    if args.sweep and hasattr(i4, "decode_form"):
        tokens = [int(t) for t in args.sweep.split(",")]
        report_steps(sweep_forms(gen, tokens), tokens)
    return 0


if __name__ == "__main__":
    sys.exit(main())
