"""Time the int4 matmul's (B3) two forms and prefill tilings on the card, side
by side in one process:

    python -m visualcla_tpu_torch.ops.cuda.bench_int4 [--ptxas] [--tokens 32,128,512]
        [--sweep 1,4,8,16,17,24,32,48,64,96,128,256] [--passes 1,16,32]

- the prefill form (wgmma) at each block tiling (``PREFILL_TILES`` 1: 64
  tokens a block, 2: 128; both 128 columns wide) and at the one
  ``prefill_tiling`` picks, at the 7B text tower's seven matmul shapes (q/k/v/o
  4096 x 4096, gate/up 4096 x 11008, down 11008 x 4096; gs 128) for each
  ``--tokens`` count, beside a bf16 ``torch.matmul`` on the dequantized weight
  (the same function) and with the max error against the plain version
  relative to the output's largest value; the average over one decoder
  layer's seven calls in turn for each tiling;
- the decode form against the prefill form at each ``--sweep`` count on the
  LLaMA-7B, Mistral-7B and Jamba shapes and heads (f32 out), with the form
  ``decode_form`` picks: the data its cost model is fitted to.  Each shape's
  calls rotate over enough copies of its carrier to leave the L2 (as a pass
  over 32 layers does), so a time is that of a weight read from device memory;
- ``--passes``: B3's device time in one pass of Mistral-7B's and Jamba's
  text towers at T tokens (32 layers' own carriers, each layer's products and
  the head: 7 x 32 + 1 calls for Mistral, 16 dense and 4 attention layers'
  and 28 Mamba layers' for Jamba), in the form the wrapper picks, beside its
  bound (the carriers' and scales' bytes at 3.35 TB/s) and, for each product,
  its 32 layers' calls alone; every call is checked against the plain
  version first (the worst error relative to max|ref| + |ref| is printed).
  A checkout without ``_launch`` (an older parent, unpacked beside this one)
  times the wrapper alone.
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
# the products of one decoder layer, (in, out), and the head (written in
# f32): Mistral-7B-v0.3 (GQA 32 / 8, MLP 14336, vocab 32768)
MISTRAL = {"q": (4096, 4096), "k": (4096, 1024), "v": (4096, 1024), "o": (4096, 4096),
           "gate": (4096, 14336), "up": (4096, 14336), "down": (14336, 4096)}
MISTRAL_HEAD = (4096, 32768)
# Jamba2-Mini's int4 products outside the experts, with the layers that run
# each: Mamba's in_proj / out_proj (28 layers), the dense MLPs (16), the
# attention layers' (4), the head (vocab 65536)
JAMBA = {"in_proj": ((4096, 16384), 28), "out_proj": ((8192, 4096), 28),
         "gate": ((4096, 14336), 16), "up": ((4096, 14336), 16), "down": ((14336, 4096), 16),
         "q": ((4096, 4096), 4), "k": ((4096, 1024), 4), "v": ((4096, 1024), 4),
         "o": ((4096, 4096), 4)}
JAMBA_HEAD = (4096, 65536)
SWEEP_SHAPES = {"7B q/k/v/o": (4096, 4096), "7B gate/up": (4096, 11008), "7B down": (11008, 4096),
                "7B head": HEAD, "mistral k/v": (4096, 1024), "mistral gate/up": (4096, 14336),
                "mistral down": (14336, 4096), "mistral head": MISTRAL_HEAD,
                "jamba in_proj": (4096, 16384), "jamba out_proj": (8192, 4096),
                "jamba head": JAMBA_HEAD}
# token counts at which both forms are timed on the 7B shapes by chip_smoke.py:
# a plain decode step of an 8-row pool (8), a speculative chunk of spec_k 8
# (9), speculative pool steps of 1-4 rows at spec_k 4 (5-20), the paged
# pool's 32-row pass, and the decode form's 16-, 32- and 64-token tiles
CROSSOVER_TOKENS = (4, 5, 8, 9, 12, 16, 17, 20, 24, 32, 48, 64)
L2_BYTES = 50e6  # an H100's L2: a shape's copies hold three times as much
HBM_BYTES_PER_S = 3.35e12


def weight(gen, in_dim, out):
    w = (torch.randn(in_dim, out, generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
    wq = quantize_grouped(w, group=128)
    return wq["q"], wq["scale"]


def random_weight(gen, in_dim, out, gs=128):
    """A carrier of random bytes and scales of a quantized 0.02-scale weight
    (every byte pattern is a valid pair of nibbles): faster to make than a
    quantized weight, the same bytes to read."""
    q = torch.randint(0, 256, (in_dim // gs, gs // 2, out), generator=gen, device="cuda",
                      dtype=torch.uint8)
    s = torch.rand(in_dim // gs, out, generator=gen, device="cuda") * 0.004 + 0.001
    return q, s


def rel_err(y, ref) -> float:
    return ((y.float() - ref).abs().max() / ref.abs().max()).item()


def prefill(x, q, s, tile):
    """The prefill form at ``tile`` (None: the one the wrapper picks).  A
    checkout older than ``_launch`` has only the wrapper, which picks the
    prefill form at ``--tokens``' counts."""
    if hasattr(i4, "_launch"):
        return i4._launch(x, q, s, form="prefill", tile=tile)
    return i4.int4_matmul(x, q, s)


def has_forms() -> bool:
    return hasattr(i4, "_launch") and hasattr(i4, "FORMS")


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
    the plain version on the first copy; prints a line a shape."""
    sms = i4._sm_count(torch.device("cuda"))
    times = {}
    for name, (in_dim, out) in SWEEP_SHAPES.items():
        copies = max(1, int(-(-3 * L2_BYTES // (in_dim * out // 2))))
        ws = [random_weight(gen, in_dim, out) for _ in range(copies)]
        out_dtype = torch.float32 if name.endswith("head") else torch.bfloat16
        times[name], cells, worst = {}, [], 0.0
        for T in tokens:
            x = torch.randn(T, in_dim, generator=gen, device="cuda").to(torch.bfloat16)
            ref = i4.int4_matmul_ref(x.float(), *ws[0])
            t = []
            for form in i4.FORMS:
                def run(i, form=form):
                    return i4._launch(x, *ws[i % copies], out_dtype, form=form)
                worst = max(worst, rel_err(run(0), ref))
                t.append(device_ms(run, calls=max(10, copies)))
            times[name][T] = tuple(t)
            pick = "decode" if i4.decode_form(T, in_dim, out, sms) else "prefill"
            slower = t[i4.FORMS.index(pick)] > min(t)
            cells.append(f"T{T} {t[0] * 1e3:.1f}/{t[1] * 1e3:.1f}{' ' + pick[0] if slower else ''}")
        print(f"[sweep] {name} ({in_dim},{out}) x{copies} copies, bound "
              f"{in_dim * out / 2 / HBM_BYTES_PER_S * 1e6:.1f}us; decode/prefill us ('d'/'p': "
              f"decode_form picks the slower, that one): " + "; ".join(cells)
              + f"; max rel err {worst:.1e}", flush=True)
        del ws
        torch.cuda.empty_cache()
    return times


def tower_products(tower: str) -> list:
    """[(name, (in, out), layers, out dtype)] of one pass of ``tower``."""
    if tower == "mistral":
        rows = [(k, v, LAYERS, torch.bfloat16) for k, v in MISTRAL.items()]
        return rows + [("head", MISTRAL_HEAD, 1, torch.float32)]
    rows = [(k, shape, n, torch.bfloat16) for k, (shape, n) in JAMBA.items()]
    return rows + [("head", JAMBA_HEAD, 1, torch.float32)]


def pass_b3(gen, tower: str, T: int, weights=None) -> dict:
    """B3 in one pass of ``tower`` at T tokens (every layer's own carrier):
    {"ms": the whole pass, "bound_ms", "launches": by form, "plain_ms",
    "products": {name: ms of its layers' calls}, "err": the largest |y -
    ref| / (max|ref| + |ref|) of any call against the plain version in
    fp32}; ``weights`` from a call before (the same tower) are reused."""
    prods = tower_products(tower)
    if weights is None:
        weights = {name: [random_weight(gen, *shape) for _ in range(n)]
                   for name, shape, n, _ in prods}
    xs = {}
    for _, (in_dim, _), _, _ in prods:
        xs.setdefault(in_dim, torch.randn(T, in_dim, generator=gen, device="cuda")
                      .to(torch.bfloat16))

    def calls(names, fn=i4.int4_matmul):
        for name, (in_dim, _), _, dt in prods:
            if name in names:
                for q, s in weights[name]:
                    fn(xs[in_dim], q, s, out_dtype=dt)

    err = 0.0

    def checked(x, q, s, out_dtype):
        nonlocal err
        ref = i4.int4_matmul_ref(x.float(), q, s)
        y = i4.int4_matmul(x, q, s, out_dtype=out_dtype).float()
        err = max(err, ((y - ref).abs() / (ref.abs().max() + ref.abs())).max().item())

    names = [p[0] for p in prods]
    before = dict(getattr(i4, "LAUNCHES", {}))
    calls(names, checked)
    torch.cuda.synchronize()
    launches = {k: v - before.get(k, 0) for k, v in getattr(i4, "LAUNCHES", {}).items()}
    ms = device_ms(lambda i: calls(names), calls=1)
    products = {name: device_ms(lambda i, name=name: calls([name]), calls=1) for name in names}
    plain_ms = device_ms(lambda i: calls(names, i4.int4_matmul_ref), calls=1, replays=1)
    nbytes = sum(n * (in_dim * out // 2 + in_dim // 128 * out * 4)
                 for _, (in_dim, out), n, _ in prods)
    return {"ms": ms, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "launches": launches,
            "plain_ms": plain_ms, "products": products, "err": err, "weights": weights}


def report_passes(gen, tokens) -> None:
    for tower in ("mistral", "jamba"):
        weights = None
        for T in tokens:
            r = pass_b3(gen, tower, T, weights)
            weights = r["weights"]
            print(f"[pass] {tower} T={T}: B3 {r['ms']:.3f} ms a pass, bound {r['bound_ms']:.3f} ms "
                  f"({100 * r['bound_ms'] / r['ms']:.1f} % of it), launches {r['launches']}, "
                  f"plain version {r['plain_ms']:.1f} ms, worst error {r['err']:.1e} of "
                  f"max|ref| + |ref|; "
                  "products: " + ", ".join(f"{k} {v * 1e3:.1f}us" for k, v in
                                             r["products"].items()), flush=True)
        del weights, r
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--tokens", default="32,128,512")
    ap.add_argument("--sweep", default="1,4,8,16,17,24,32,48,64,96,128,256")
    ap.add_argument("--passes", default="1,16,32")
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
    if args.passes:
        report_passes(gen, [int(t) for t in args.passes.split(",")])
    if args.tokens:
        bench_tilings(gen, [int(t) for t in args.tokens.split(",")])
    if args.sweep and has_forms() and hasattr(i4, "decode_form"):
        tokens = [int(t) for t in args.sweep.split(",")]
        sweep_forms(gen, tokens)
    return 0


if __name__ == "__main__":
    sys.exit(main())
