"""Find a cell's knee: serve the cell's traffic at several fixed rates, one
window each, on one set-up, and print each rate's numbers.

    python3 benchmark/tools/sweep.py --workload <cell> --seed <n> --rates 4,6,8 --seconds 20

A rate is sustained when the queue does not grow through the window: the
requests due in its last third wait for their first token about as long as
those due in its first third, and every request due in the window has its
first token within a few seconds of its window's close.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

from benchmark import run  # noqa: E402
from benchmark.harness.readings import done, tail, ttfts  # noqa: E402


def summary(record: dict) -> dict:
    reqs = record["requests"]
    t = ttfts(record)
    due = np.asarray([r.due - record["t0"] for r in reqs])
    T = record["t1"] - record["t0"]
    first, last = t[due < T / 3], t[due >= 2 * T / 3]
    n_tok = sum(1 for r in reqs for x in r.times if record["t0"] <= x < record["t1"])
    per = [(r.times[-1] - r.times[0]) / (len(r.times) - 1) for r in reqs
           if done(r) and len(r.times) >= 2]
    waiting = sum(1 for r in reqs if not r.times or r.times[0] > record["t1"])
    return {"requests": len(reqs), "failed": sum(1 for r in reqs if not done(r)),
            "ttft_p50_ms": tail(t, 50) * 1e3, "ttft_p95_ms": tail(t, 95) * 1e3,
            "ttft_first_third_p50_ms": tail(first, 50) * 1e3 if len(first) else None,
            "ttft_last_third_p50_ms": tail(last, 50) * 1e3 if len(last) else None,
            "tpot_p95_ms": tail(per, 95) * 1e3 if per else None,
            "output_tok_s": n_tok / T, "without_first_token_at_close": waiting}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        run.log("no CUDA device")
        return 1
    cell = run.load_json(run.BENCH, "workloads", args.workload + ".json")
    cfg = run.load_config(cell["config"])
    driver = run.load_module(os.path.join(run.BENCH, "drivers", cell["driver"] + ".py"),
                             "benchmark_driver_" + cell["driver"])
    run.prebuild_kernels()
    ctx = types.SimpleNamespace(cfg=cfg, cell=cell, seed=args.seed, seconds=args.seconds,
                                trace=False, device=torch.device("cuda"), log=run.log)
    stack = driver.set_up(ctx)
    for i, rate in enumerate(float(r) for r in args.rates.split(",")):
        ctx.seed = args.seed + i
        reqs = driver.plan(ctx, args.seconds, rate=rate)
        record = driver.window(ctx, stack, reqs, args.seconds, False)
        print(json.dumps({"rate_per_s": rate, **summary(record)}), flush=True)
    stack.worker.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
