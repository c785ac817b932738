"""Kernel B3 (``ops/cuda/int4_matmul``, both forms) on a Jamba tower against
its bound, in percent: ``b3_roofline``'s reckoning over the products B3 runs
there (``counts_jamba.int4_matmuls``: the attention layers' four, the Mamba
mixers' in_proj and out_proj, the dense MLPs' three; the head), each decode
pass at T = the pool's rows and each admission whose first token arrived in
the slice at its prompt bucket's tokens (the head at one), over the device
time of the kernels named in ``b3_roofline.kernels.json``."""
import os

from benchmark.harness import counts_jamba
from benchmark.harness.readings import bucket, delta, kernel_seconds, tokens_between

KERNELS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "b3_roofline.kernels.json")


def read(record):
    cfg = record["cfg"]
    if cfg.get("model_type") != "jamba" or cfg["weights"] != "int4":
        return None
    t = kernel_seconds(record, KERNELS)
    if t is None:
        return None
    sl = record["slice"]
    rows = cfg["pool"]["rows"]
    passes = delta(sl["c0"], sl["c1"], "counts", "decode_passes")
    bound = passes * counts_jamba.int4_pass_bound_s(cfg, rows, rows)
    for r, j in tokens_between(record, sl["t0"], sl["t1"]):
        if j == 0:
            bound += counts_jamba.int4_pass_bound_s(cfg, bucket(len(r.prompt_ids)), 1)
    return 100.0 * bound / t
