"""B1's share (%) of its roofline: the least time of the window's paged
attention reads, counted from each step's own segments
(``bench/harness/account.py``), over the device time of the paged
attention kernel family in the trace."""
from bench.harness import account


def read(run):
    if run.trace is None or not run.steps:
        return None
    t = run.trace.family_s("attention", run.moe)
    if t <= 0:
        return None
    least = sum(account.b1_least_s(run.cfg, s.segments) for s in run.steps)
    return 100.0 * least / t
