"""Mean wait of a request in the Scheduler's queue, from its submit to the
start of its admission, over the admissions started in the window
(Δ``Scheduler.stats()["t_queue_wait"]`` / Δ(``prefills`` +
``chunked_admissions``)), in ms.  None where the program keeps no such
counter."""
from benchmark.harness.readings import delta


def read(record):
    c0, c1 = record["c0"], record["c1"]
    if "t_queue_wait" not in c0["stats"]:
        return None
    n = delta(c0, c1, "stats", "prefills") + delta(c0, c1, "stats", "chunked_admissions")
    return 1e3 * delta(c0, c1, "stats", "t_queue_wait") / n if n else None
