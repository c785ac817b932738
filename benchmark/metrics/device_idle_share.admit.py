"""Share of the profiled slice in which the card was idle while the
Scheduler's thread was inside an admission span (``sched.admit``,
``sched.admit_begin``, ``sched.admit_stage``), in percent: the part of
``device_idle_share.serve`` that admissions leave.  None where the slice
holds no device events or spans."""
from benchmark.harness.spans import ADMIT, idle_s_under


def read(record):
    idle = idle_s_under(record, ADMIT)
    if idle is None:
        return None
    w0, w1 = record["slice"]["wall_ns"]
    return 100.0 * idle / ((w1 - w0) * 1e-9)
