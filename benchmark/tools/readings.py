"""The readings that a cell's correctness limit is set from: for each seed,
one short window of the cell's traffic, then the widest gap of a served
token below what the reference's sampler keeps, its best logit for a greedy
request (the program's reading) and, at the same prompts and tokens, the
widest gap of the token that the control's processed logits put first (the
control: the reference in the next precision below the one the
configuration states, its ``control`` entry).  One process, one line a seed.

    python3 benchmark/tools/readings.py --workload <cell> --seeds 1,2,3 --seconds 20 [--faults]

``--faults`` also reads the served faults a cell can have, each planted in
the reference put in the program's place: a token altered where it is
produced (the reference's best token + 1), and a step that leaves its state
unchanged (every token after the first is the first again).
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


def control_readings(record: dict, ctx, driver, faults: bool) -> dict:
    from benchmark.harness import weights
    from benchmark.reference.model import Reference

    cfg, cell = record["cfg"], record["cell"]
    sample = driver.sample_for_check(record, ctx.seed, cell["check"])
    seqs = driver.reference_seqs(record, sample)
    w = weights.make(cfg, ctx.seed, ctx.device)
    ref_logits = Reference(cfg, w).logits(seqs)
    sampled = [i for i, s in enumerate(seqs) if s["config"]["do_sample"]]
    out = {"program": driver.gaps(ref_logits, seqs),
           "program_sampled": driver.gaps([ref_logits[i] for i in sampled],
                                          [seqs[i] for i in sampled]),
           "tokens": sum(len(s["served"]) for s in seqs),
           "sampled_tokens": sum(len(seqs[i]["served"]) for i in sampled)}
    ctl = Reference(cfg, w, precision=cfg["control"]).logits(seqs)
    out["control"] = driver.gaps(ref_logits, seqs, tokens=driver.choices(ctl, seqs))
    del ctl
    if faults:
        V = ref_logits[0].shape[-1]
        best = driver.choices(ref_logits, seqs)
        out["fault_token_altered"] = driver.gaps(ref_logits, seqs,
                                                 tokens=[(b + 1) % V for b in best])
        out["fault_state_unchanged"] = driver.gaps(ref_logits, seqs,
                                                   tokens=[b[:1].expand(len(b)) for b in best])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args(argv)
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
    run.prebuild_kernels()
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        ctx = types.SimpleNamespace(cfg=cfg, cell=cell, seed=seed, seconds=args.seconds,
                                    trace=False, device=torch.device("cuda"), log=run.log)
        record = driver.run(ctx)
        gc.collect()
        torch.cuda.empty_cache()
        checks = driver.check(record, ctx)
        line = {"seed": seed, **{k: v["value"] for k, v in checks.items()},
                **control_readings(record, ctx, driver, args.faults),
                "seconds": time.perf_counter() - t}
        print(json.dumps(line), flush=True)
        del record
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
