"""95th percentile, in ms, of (last token - first token) / (tokens - 1)
over the requests that finished inside the window."""
from bench.harness import stats


def read(run):
    v = stats.percentile(stats.tpots(run.requests, run.window), 95)
    return None if v is None else v * 1e3
