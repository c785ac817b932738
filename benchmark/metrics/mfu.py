"""The useful operations of the profiled slice over the time the card was
busy in it at its bf16 peak, in percent: for each first token received in
the slice its admission (the image's encode, the unpadded prompt, causal
attention, the head for one token), for each later token one decode step at
its context; over the slice's busy seconds (the union of its device
intervals) x 989 TFLOP/s.  At a fixed offered load the work is fixed, so
the share rises only where the card does it in less time."""
from benchmark.harness import counts
from benchmark.harness.readings import tokens_between


def read(record):
    sl = record.get("slice")
    if not sl or not sl["busy_s"]:
        return None
    cfg = record["cfg"]
    ops = 0.0
    for r, j in tokens_between(record, sl["t0"], sl["t1"]):
        S = len(r.prompt_ids)
        ops += counts.prefill_ops(cfg, S) if j == 0 else counts.decode_ops(cfg, S + j)
    return 100.0 * ops / (sl["busy_s"] * counts.BF16_OPS_PER_S)
