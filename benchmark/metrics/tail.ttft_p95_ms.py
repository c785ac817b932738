"""95th percentile of the time to first token over every request due in the
window, from its due time; a failed request counts as waiting until the
drain ended (host clock).  Reported per layer, in traced runs: at this load
its runs spread too widely to bound it end to end."""
from benchmark.harness.readings import tail, ttfts


def read(record):
    return tail(ttfts(record), 95) * 1e3
