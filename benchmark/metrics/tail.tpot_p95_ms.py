"""95th percentile, over the window's finished requests with two tokens or
more, of (last token - first token) / (tokens - 1) (host clock).  Reported
per layer, in traced runs: at this load its runs spread too widely to bound
it end to end."""
from benchmark.harness.readings import done, tail


def read(record):
    per = [(r.times[-1] - r.times[0]) / (len(r.times) - 1)
           for r in record["requests"] if done(r) and len(r.times) >= 2]
    return tail(per, 95) * 1e3 if per else None
