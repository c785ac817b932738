"""Device time of a decode pass: the device seconds of the slice's kernels
launched under ``sched.decode`` spans over the decode passes run in the
slice (Δ``counts["decode_passes"]``, gated ones included), in ms.  None
where the slice holds no device events or spans."""
from benchmark.harness.readings import delta
from benchmark.harness.spans import device_s_by_top


def read(record):
    by_top = device_s_by_top(record)
    sl = record.get("slice")
    if by_top is None or "sched.decode" not in by_top:
        return None
    passes = delta(sl["c0"], sl["c1"], "counts", "decode_passes")
    return 1e3 * by_top["sched.decode"] / passes if passes else None
