"""Kernel B3 (``ops/cuda/int4_matmul``, both forms) against its bound, in
percent: the least time of the slice's int4 products (each decode pass:
every layer's seven products and the head at T = the pool's rows; each
admission whose first token arrived in the slice: the layers at its prompt
bucket's tokens and the head at one; each call the larger of its bytes over
3.35 TB/s and its operations over 989 TFLOP/s) over the device time of the
kernels named in ``b3_roofline.kernels.json`` in the profiled slice."""
from benchmark.harness import counts
from benchmark.harness.readings import beside, bucket, delta, kernel_seconds, tokens_between


def read(record):
    cfg = record["cfg"]
    if cfg["weights"] != "int4":
        return None
    t = kernel_seconds(record, beside(__file__, ".kernels.json"))
    if t is None:
        return None
    sl = record["slice"]
    rows = cfg["pool"]["rows"]
    passes = delta(sl["c0"], sl["c1"], "counts", "decode_passes")
    bound = passes * counts.int4_pass_bound_s(cfg, rows, rows)
    for r, j in tokens_between(record, sl["t0"], sl["t1"]):
        if j == 0:
            bound += counts.int4_pass_bound_s(cfg, bucket(len(r.prompt_ids)), 1)
    return 100.0 * bound / t
