"""Kernel B4 (``ops/cuda/paged_attention``) on a Jamba tower against its
bound, in percent: ``b4_roofline``'s reckoning over the tower's attention
layers alone (each decoded token at context c reads c cached positions' keys
and values and writes its own, with its query and output, in each of them)
over the device time of the kernels named in ``b4_roofline.kernels.json``."""
import os

from benchmark.harness import counts_jamba
from benchmark.harness.readings import kernel_seconds, tokens_between

KERNELS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "b4_roofline.kernels.json")


def read(record):
    cfg = record["cfg"]
    if cfg.get("model_type") != "jamba":
        return None
    t = kernel_seconds(record, KERNELS)
    if t is None:
        return None
    sl = record["slice"]
    nbytes = ops = 0.0
    for r, j in tokens_between(record, sl["t0"], sl["t1"]):
        if j >= 1:
            b, o = counts_jamba.b4_token_bound(cfg, len(r.prompt_ids) + j - 1)
            nbytes += b
            ops += o
    return 100.0 * counts_jamba.bound_s(nbytes, ops) / t
