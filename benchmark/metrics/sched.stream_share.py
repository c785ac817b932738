"""Share of the window the Scheduler's loop spent reading the pool's state
back and handing tokens to the requests (``t_snapshot`` + ``t_stream``;
``t_collect``, the release of finished rows, lies inside ``t_stream``), in
percent.  The snapshot waits for the decode chunk on the device."""
from benchmark.harness.readings import delta, window_s


def read(record):
    c0, c1 = record["c0"], record["c1"]
    t = delta(c0, c1, "stats", "t_snapshot") + delta(c0, c1, "stats", "t_stream")
    return 100.0 * t / window_s(record)
