"""Run one cell of the benchmark once and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is ``benchmark/workloads/<cell>.json``; it names its configuration
(``benchmark/configs/<config>.json``) and its driver
(``benchmark/drivers/<driver>.py``), which sets the program up from the seed,
warms it and runs the measured window.  The metrics are the cell's entries in
``BENCHMARK.json``: with ``--trace 0`` its end-to-end metrics, with
``--trace 1`` its per-layer ones, each read by ``benchmark/metrics/<name>.py``
from the run's record.  Then the plain reference judges a sample of what the
window served.  The last line of standard output is the result, one JSON
object whose last key, ``checks``, holds the numbers compared, each beside
its limit; the last lines of standard error repeat them.  Without a CUDA
device the run exits with 1 and prints no result, as it does when JAX or
the JAX package was loaded.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")
# caches of compilers the program may use, at fixed paths inside the checkout
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(REPO, ".bench_cache", "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(REPO, ".bench_cache",
                                                           "torch_extensions"))
os.environ.setdefault("USE_FLAX", "0")
if REPO not in sys.path:
    sys.path.insert(0, REPO)

FORBIDDEN = ("jax", "jaxlib", "flax", "visualcla_tpu")


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


# a configuration file holds its text tower's published config.json keys at
# its top level; the harness reads them as ``text_config``
TEXT_KEYS = ("hidden_size", "intermediate_size", "num_hidden_layers", "num_attention_heads",
             "num_key_value_heads", "vocab_size", "rope_theta", "rms_norm_eps",
             "max_position_embeddings", "hidden_act", "tie_word_embeddings")


def load_config(name: str) -> dict:
    cfg = load_json(BENCH, "configs", name + ".json")
    cfg["text_config"] = {k: cfg[k] for k in TEXT_KEYS if k in cfg}
    return cfg


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(manifest: dict, cell: str, trace: bool) -> list:
    """The manifest's metrics this cell reports in this kind of run: every
    end-to-end metric; a per-layer one where its ``workloads`` name the cell."""
    if not trace:
        return manifest["end_to_end"]
    return [m for m in manifest["per_layer"] if cell in m["workloads"]]


def read_metrics(metrics: list, record: dict) -> dict:
    out = {}
    for m in metrics:
        reader = load_module(os.path.join(BENCH, "metrics", m["name"] + ".py"),
                             "benchmark_metric_" + m["name"].replace(".", "_"))
        value = reader.read(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules() -> list:
    return sorted({k.split(".")[0] for k in sys.modules} & set(FORBIDDEN))


def prebuild_kernels() -> None:
    from benchmark.harness.program import prebuild

    prebuild(log)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, device=None,
             cfg: dict = None, cell: dict = None, arrival_seed: int = None):
    """-> the result dict, or None where the run has none to print.
    ``device``, ``cfg`` and ``cell`` stand in for the card and the files in
    the benchmark's own tests; ``arrival_seed`` replaces the cell's arrival
    path by another."""
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
            log("no CUDA device: torch.cuda.is_available() is False or no card is visible; "
                "the benchmark measures the card and never runs on the CPU")
            return None
        device = torch.device("cuda")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cell = cell or load_json(BENCH, "workloads", workload + ".json")
    if arrival_seed is not None:
        cell = {**cell, "arrival_seed": arrival_seed}
    cfg = cfg or load_config(cell["config"])
    manifest = load_json(REPO, "BENCHMARK.json")
    driver = load_module(os.path.join(BENCH, "drivers", cell["driver"] + ".py"),
                         "benchmark_driver_" + cell["driver"])
    if device.type == "cuda":
        prebuild_kernels()
    ctx = types.SimpleNamespace(cfg=cfg, cell=cell, seed=seed, seconds=seconds, trace=trace,
                                device=device, log=log)
    record = driver.run(ctx)
    record["setup_s"] = record["t0"] - T_PROCESS
    metrics = read_metrics(cell_metrics(manifest, workload, trace), record)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = driver.check(record, ctx)
    found = forbidden_modules()
    if found:
        log(f"modules of JAX or of the JAX package are loaded: {', '.join(found)}")
        return None
    attempted = len(record["requests"])
    failed = sum(1 for r in record["requests"] if r.final is None or r.error is not None)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(record["memory_peak_bytes"])}
    result = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": attempted, "failed": failed, "metrics": metrics, "device": dev}
    if trace and record.get("slice"):
        from benchmark.harness.trace import breakdown

        dev["busy_s"] = record["slice"]["busy_s"]
        dev["window_s"] = record["slice"]["window_s"]
        result["breakdown"] = breakdown(record["slice"])
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--arrival-seed", type=int, default=None,
                    help="serve another arrival path than the cell's own (to see whether a "
                         "change to the tails holds on other paths)")
    args = ap.parse_args(argv)
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      arrival_seed=args.arrival_seed)
    if result is None:
        return 1
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
