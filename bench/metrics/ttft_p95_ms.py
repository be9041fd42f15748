"""95th percentile, in ms, of the time from a request's due time to its
first token, over every request due in the window (open loop only).  A
request still waiting when the run stopped counts with its wait."""
from bench.harness import stats


def read(run):
    if run.loop != "open":
        return None
    v = stats.percentile(stats.ttfts(run.window_reqs, run.t_end, run.window),
                         95)
    return None if v is None else v * 1e3
