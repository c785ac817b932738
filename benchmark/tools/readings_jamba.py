"""The readings that the Jamba cell's correctness limit is set from: for each
weight seed one set-up, then for each traffic seed one short window of the
cell's traffic and its readings (``serve_open_loop_jamba.readings``: the
program's widest gap, each control's, a token altered).  One line a window.

    python3 benchmark/tools/readings_jamba.py --workload jamba2mini-int4-serve-poisson \\
        --weight-seeds 1,2 --seeds 11,12,13 --seconds 10 \\
        [--controls '{"ssm_bf16": {"weights": "int4", "kv": "int8", "ssm_state": "bf16"}}'] \\
        [--fault drop_state|pad_decay]

A set-up (the weights drawn, loaded and quantized, the warm-up) is shared by
that weight seed's windows, so many readings cost one set-up each.  Each
line also reads ``port_forward``: the served model's own full forward over
the judged sequences (teacher-forced, one pass each, not through the pool),
which tells the precision's share of the program's gap from the pool's.
``--fault`` plants one of ``FAULTS`` in the served program before its
set-up, so that its readings (``program``) are those of a broken state
path at the cell's own size; ``--controls '{}'`` reads no control.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from benchmark import run  # noqa: E402


def drop_state_at_chunks(patch=setattr) -> None:
    """A fault: every admission chunk after the first starts from zeroed
    Mamba states, as if the state were lost at the chunk boundary."""
    from visualcla_tpu_torch.models.jamba import Jamba

    orig = Jamba.forward

    def forward(self, e, pos, cache, valid, c0, **kw):
        if c0 > 0:
            for name in ("conv", "ssm", "conv_saved", "ssm_saved"):
                cache[name].zero_()
        return orig(self, e, pos, cache, valid, c0, **kw)

    patch(Jamba, "forward", forward)


def padding_decays_the_state(patch=setattr) -> None:
    """A fault: an admission chunk's right padding runs through the conv and
    the scan as if it were real, so the state kept is the one after the
    padding."""
    import torch

    from visualcla_tpu_torch.ops.cuda import selective_scan as b8

    conv, scan = b8.conv_chunk, b8.scan_chunk

    def every(lens, x):
        return torch.full_like(lens, x.shape[1])

    patch(b8, "conv_chunk", lambda x, w, b, s, lens: conv(x, w, b, s, every(lens, x)))
    patch(b8, "scan_chunk", lambda u, dt, bias, A, B, C, D, z, s, lens:
          scan(u, dt, bias, A, B, C, D, z, s, every(lens, u)))


# faults planted under the served path; ``patch(obj, name, value)`` is
# ``setattr`` here and pytest's ``monkeypatch.setattr`` in the tests
FAULTS = {"drop_state": drop_state_at_chunks, "pad_decay": padding_decays_the_state}


def port_forward(stack, device):
    """seqs -> the port's own teacher-forced logits (the served model, one
    full forward a sequence, the reference's pixels)."""
    import torch

    from visualcla_tpu_torch.models import visualcla

    model, pcfg = stack.model, stack.bundle.config

    @torch.no_grad()
    def fn(seqs):
        out = []
        for s in seqs:
            ids = torch.as_tensor(s["ids"], device=device)[None]
            pix = torch.as_tensor(s["pixels"], device=device)[None].to(torch.bfloat16)
            pos = torch.tensor([s["img_start"]], device=device)
            emb = visualcla.multimodal_embeds(model, pcfg, ids, pos, pix)
            out.append(model.text.forward_logits(ids, inputs_embeds=emb)[0, s["prompt_len"] - 1:])
        return out

    return fn


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--weight-seeds", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rate", type=float, default=None)
    ap.add_argument("--controls", default=None, help="JSON: name -> reference precision")
    ap.add_argument("--fault", default=None, choices=sorted(FAULTS))
    args = ap.parse_args(argv)
    if args.fault:
        FAULTS[args.fault]()
    import torch

    if not torch.cuda.is_available():
        run.log("no CUDA device")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = run.load_json(run.BENCH, "workloads", args.workload + ".json")
    cfg = run.load_config(cell["config"])
    driver = run.load_module(os.path.join(run.BENCH, "drivers", cell["driver"] + ".py"),
                             "benchmark_driver_" + cell["driver"])
    controls = json.loads(args.controls) if args.controls else None
    run.prebuild_kernels()
    for wseed in (int(s) for s in args.weight_seeds.split(",")):
        ctx = types.SimpleNamespace(cfg=cfg, cell=cell, seed=wseed, seconds=args.seconds,
                                    trace=False, device=torch.device("cuda"), log=run.log)
        stack = driver.set_up(ctx)
        for seed in (int(s) for s in args.seeds.split(",")):
            t = time.perf_counter()
            ctx.seed = seed
            reqs = driver.plan(ctx, args.seconds, rate=args.rate)
            record = driver.window(ctx, stack, reqs, args.seconds, False)
            gc.collect()
            line = {"weight_seed": wseed, "seed": seed, "fault": args.fault,
                    **driver.readings(record, ctx, weights_seed=wseed, controls=controls,
                                      others={"port_forward": port_forward(stack, ctx.device)}),
                    "failed": sum(1 for r in record["requests"] if r.final is None),
                    "seconds": time.perf_counter() - t}
            print(json.dumps(line), flush=True)
            del record
            gc.collect()
            torch.cuda.empty_cache()
        stack.worker.close()
        del stack
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
