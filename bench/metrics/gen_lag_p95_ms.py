"""95th percentile, in ms, of submit time - due time of the open loop's
requests due in the window: how late the generator sent them (it sends
between engine steps)."""
from bench.harness import stats


def read(run):
    if run.loop != "open":
        return None
    t0, t1 = run.window
    lag = [r.submit - r.due for r in run.window_reqs if t0 <= r.due < t1]
    v = stats.percentile(lag, 95)
    return None if v is None else v * 1e3
