"""The useful operations of the profiled slice over the time the card was
busy in it at its bf16 peak, in percent, for a Jamba tower
(``harness/counts_jamba``): for each first token received in the slice its
admission (the image's encode, the unpadded prompt's products, causal
attention in the attention layers, the scan, the head for one token), for
each later token one decode step at its context (its products, the router
and its top-k experts, attention over its context, a scan step); over the
slice's busy seconds (the union of its device intervals) x 989 TFLOP/s."""
from benchmark.harness import counts_jamba
from benchmark.harness.readings import tokens_between


def read(record):
    sl, cfg = record.get("slice"), record["cfg"]
    if not sl or not sl["busy_s"] or cfg.get("model_type") != "jamba":
        return None
    ops = 0.0
    for r, j in tokens_between(record, sl["t0"], sl["t1"]):
        S = len(r.prompt_ids)
        ops += (counts_jamba.prefill_ops(cfg, S) if j == 0
                else counts_jamba.decode_ops(cfg, S + j))
    return 100.0 * ops / (sl["busy_s"] * counts_jamba.BF16_OPS_PER_S)
