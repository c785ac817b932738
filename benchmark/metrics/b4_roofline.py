"""Kernel B4 (``ops/cuda/paged_attention``, the paged append attention of
each decode step) against its bound, in percent: the least time the
slice's decoded tokens needed (each token at context c reads c cached
positions' keys and values in every layer and writes its own, plus its
query, new keys and values and output, at 3.35 TB/s, or its operations at
989 TFLOP/s if more) over the device time of the kernels named in
``b4_roofline.kernels.json`` in the profiled slice."""
from benchmark.harness import counts
from benchmark.harness.readings import beside, kernel_seconds, tokens_between


def read(record):
    t = kernel_seconds(record, beside(__file__, ".kernels.json"))
    if t is None:
        return None
    cfg, sl = record["cfg"], record["slice"]
    L = cfg["text_config"]["num_hidden_layers"]
    nbytes = ops = 0.0
    for r, j in tokens_between(record, sl["t0"], sl["t1"]):
        if j >= 1:
            cached = len(r.prompt_ids) + j - 1
            nbytes += L * counts.paged_append_bytes(cfg, cached)
            ops += L * counts.paged_append_ops(cfg, cached)
    return 100.0 * counts.bound_s(nbytes, ops) / t
