"""Share of the window the Scheduler's loop spent admitting requests
(``Scheduler.stats()["t_prefill"]``: one-shot admissions and chunked
admissions' stages), in percent."""
from benchmark.harness.readings import delta, window_s


def read(record):
    return 100.0 * delta(record["c0"], record["c1"], "stats", "t_prefill") / window_s(record)
