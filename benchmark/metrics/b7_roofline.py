"""Kernel B7 (``ops/cuda/moe_int4``, the experts' grouped int4 products)
against its bound, in percent: the least time of the experts' work in the
profiled slice (the int4 carriers and scales of every expert that got a
token in an MoE layer's pass, ``counts["moe_experts_hit"]``; the routed
tokens' activations and 2 x 3 x H x I operations an assignment,
``counts["moe_expert_tokens"]``; both as the slice's counters moved; the
larger of the bytes over 3.35 TB/s and the operations over 989 TFLOP/s)
over the device time of the kernels named in ``b7_roofline.kernels.json``.
The counters are read back with each decode chunk, so an admission's
assignments count from the chunk after it."""
from benchmark.harness import counts_jamba
from benchmark.harness.readings import beside, kernel_seconds


def read(record):
    cfg = record["cfg"]
    if cfg.get("model_type") != "jamba":
        return None
    t = kernel_seconds(record, beside(__file__, ".kernels.json"))
    if t is None:
        return None
    c0, c1 = record["slice"]["c0"]["counts"], record["slice"]["c1"]["counts"]
    if "moe_experts_hit" not in c1:
        return None
    hit = c1["moe_experts_hit"] - c0["moe_experts_hit"]
    assignments = sum(c1["moe_expert_tokens"]) - sum(c0["moe_expert_tokens"])
    return 100.0 * counts_jamba.b7_bound_s(cfg, hit, assignments) / t
