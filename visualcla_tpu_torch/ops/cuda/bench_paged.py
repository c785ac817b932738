"""Time the split-KV paged kernels' (B4, B5, B6) run length on the card, side
by side in one process:

    python -m visualcla_tpu_torch.ops.cuda.bench_paged [--ptxas] [--runs 64,128,256]

For each ``--runs`` value (kv slots a split, ``VCLA_VERIFY_RUN``, a
compile-time constant of ``csrc/paged_attention.cu``: one build per value):

- B5 (verify attention) at the serve phase's shape, B = 4 rows of 318 / 383 /
  330 old tokens and a parked row, Sq 5 and 9, MHA; GQA (8 kv heads) at Sq 9;
  B = 8 rows of 2039 old tokens at Sq 9; bf16 and int8 pools;
- B6 (decode without an append) at B = 4 rows of 320 / 383 / 330 tokens and a
  parked row, bf16 and int8 pools;
- B4 (decode with the append) at the same rows, MHA and GQA, in the table the
  rows need and in one 2048 slots wide (the serve phase's), and at B = 8 rows
  of 2047 tokens, bf16 and int8 pools;

each with its max abs error against the plain version on the running rows
and whether a second call gives the same bits.  The 7B heads (hd 128), BS
64, a 32-layer pool; times are device times from a CUDA graph of one call a
layer over the 32 layers in turn (launch gaps excluded).  ``--ptxas`` also
prints registers and spills of every kernel instance.  Needs a GPU and nvcc.
"""
from __future__ import annotations

import argparse
import subprocess
import sys

import torch

from . import build
from . import paged_attention as pa
from .bench_flash import device_ms, ptxas_report
from ...fixtures import paged_case, paged_decode_args, paged_verify_case


def rebuild(run: int) -> None:
    """Load the library built with ``run`` kv slots a split."""
    base = tuple(f for f in build.NVCC_FLAGS if not f.startswith("-DVCLA_VERIFY_RUN"))
    build.NVCC_FLAGS = base + (f"-DVCLA_VERIFY_RUN={run}",)
    build._LIBS.pop("paged_attention", None)
    pa._lib = None
    pa.build_kernels()


def _err(out, ref, rows) -> float:
    return (out[rows].float() - ref[rows].float()).abs().max().item()


def bench_verify(run: int) -> None:
    ragged = [318, 383, 330, -1]
    for label, ctx, Sq, Nkv in (("B4 ragged", ragged, 5, 32), ("B4 ragged", ragged, 9, 32),
                                ("B4 ragged GQA", ragged, 9, 8),
                                ("B8x2048", [2048 - 9] * 8, 9, 32)):
        for kv8 in (False, True):
            case = paged_verify_case(ctx, Sq, 32, Nkv, L=32, layer=7, dtype=torch.bfloat16,
                                     kv_int8=kv8, device="cuda", seed=Sq + Nkv)
            rows = [b for b, c in enumerate(ctx) if c >= 0]
            ref_case = {k: (v.clone() if torch.is_tensor(v) else v) for k, v in case.items()}
            out = pa.paged_verify_attention(**case)
            again = pa.paged_verify_attention(**case)
            ref = pa.paged_verify_attention_ref(**ref_case)
            L = case["k_pool"].shape[0]
            ms = device_ms(lambda i: pa.paged_verify_attention(**{**case, "layer": i % L}),
                           calls=L)
            print(f"[verify run={run}] {label} Sq{Sq} N32/{Nkv} {'int8' if kv8 else 'bf16'}: "
                  f"{ms * 1e3:.1f}us, err {_err(out, ref, rows):.2e}, bitwise repeat "
                  f"{torch.equal(out, again)}", flush=True)
            del case, ref_case
            torch.cuda.empty_cache()


def bench_decode(run: int) -> None:
    for kv8 in (False, True):
        case = paged_case([320, 383, 330, -1], 32, 32, L=32, layer=7, dtype=torch.bfloat16,
                          kv_int8=kv8, device="cuda", seed=3)
        args = paged_decode_args(case)
        out = pa.paged_decode_attention(**args)
        again = pa.paged_decode_attention(**args)
        ref = pa.paged_decode_attention_ref(**args)
        L = case["k_pool"].shape[0]
        ms = device_ms(lambda i: pa.paged_decode_attention(**paged_decode_args(case, i % L)),
                       calls=L)
        print(f"[decode run={run}] B4 ragged N32/32 {'int8' if kv8 else 'bf16'}: "
              f"{ms * 1e3:.1f}us, err {_err(out, ref, slice(None)):.2e}, bitwise repeat "
              f"{torch.equal(out, again)}", flush=True)
        del case, args
        torch.cuda.empty_cache()


def bench_append(run: int) -> None:
    ragged = [320, 383, 330, -1]
    for label, ctx, Nkv, wide in (("B4 ragged", ragged, 32, False),
                                  ("B4 ragged, 2048-slot table", ragged, 32, True),
                                  ("B4 ragged GQA", ragged, 8, False),
                                  ("B8x2048", [2047] * 8, 32, False)):
        for kv8 in (False, True):
            case = paged_case(ctx, 32, Nkv, L=32, layer=7, dtype=torch.bfloat16, kv_int8=kv8,
                              device="cuda", seed=Nkv + len(ctx))
            if wide:
                case["tables"] = torch.nn.functional.pad(
                    case["tables"], (0, 32 - case["tables"].shape[1]))
            ref_case = {k: (v.clone() if torch.is_tensor(v) else v) for k, v in case.items()}
            out = pa.paged_append_attention(**case)
            again = pa.paged_append_attention(**case)
            ref = pa.paged_append_attention_ref(**ref_case)
            L = case["k_pool"].shape[0]
            ms = device_ms(lambda i: pa.paged_append_attention(**{**case, "layer": i % L}),
                           calls=L)
            print(f"[append run={run}] {label} N32/{Nkv} {'int8' if kv8 else 'bf16'}: "
                  f"{ms * 1e3:.1f}us, err {_err(out, ref, slice(None)):.2e}, bitwise repeat "
                  f"{torch.equal(out, again)}", flush=True)
            del case, ref_case
            torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--runs", default="128")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_paged: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    if args.ptxas:
        ptxas_report("paged_attention")
    for run in (int(r) for r in args.runs.split(",")):
        rebuild(run)
        print(f"paged_attention.cu built in {build.build_seconds.get('paged_attention', 0):.1f} s "
              f"(VCLA_VERIFY_RUN={run})", flush=True)
        bench_append(run)
        bench_verify(run)
        bench_decode(run)
    return 0


if __name__ == "__main__":
    sys.exit(main())
