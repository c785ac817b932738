"""Kernel B8 (``ops/cuda/selective_scan``, Mamba's conv and selective scan,
both forms) against its bound, in percent: the least time of the slice's
scan work (for each admission whose first token arrived in the slice, its
prompt's real tokens, and for each later token one decode step, in each
Mamba layer: the conv's and the scan's inputs and outputs, a decode step
also its row's conv and f32 SSM states read and written; at 3.35 TB/s, or
its operations at 989 TFLOP/s if more) over the device time of the kernels
named in ``b8_roofline.kernels.json`` in the profiled slice."""
from benchmark.harness import counts_jamba
from benchmark.harness.readings import beside, kernel_seconds, tokens_between


def read(record):
    cfg = record["cfg"]
    if cfg.get("model_type") != "jamba":
        return None
    t = kernel_seconds(record, beside(__file__, ".kernels.json"))
    if t is None:
        return None
    sl = record["slice"]
    prompt = decode = 0
    for r, j in tokens_between(record, sl["t0"], sl["t1"]):
        if j == 0:
            prompt += len(r.prompt_ids)
        else:
            decode += 1
    return 100.0 * counts_jamba.b8_bound_s(cfg, prompt, decode) / t
