"""95th percentile, in ms, of (last token - first token) / (tokens - 1)
over the requests that finished inside the traced run's window: the
quantity of ``tpot_p95_ms``, read per layer in cells whose seeds move
it too far for an end-to-end bound (the profiler slows the host)."""
from bench.harness import stats


def read(run):
    v = stats.percentile(stats.tpots(run.requests, run.window), 95)
    return None if v is None else v * 1e3
