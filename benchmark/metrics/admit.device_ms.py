"""Device time of an admission: the device seconds of the slice's kernels
launched under the Scheduler's admission spans (``sched.admit``,
``sched.admit_begin``, ``sched.admit_stage``) over the admissions completed
in them, in ms.  None where the slice holds no device events or spans."""
from benchmark.harness.spans import ADMIT, completed_admissions, device_s_by_top, slice_spans


def read(record):
    by_top = device_s_by_top(record)
    if by_top is None:
        return None
    n = completed_admissions(slice_spans(record))
    return 1e3 * sum(by_top.get(k, 0.0) for k in ADMIT) / n if n else None
