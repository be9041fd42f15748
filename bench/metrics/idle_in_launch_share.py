"""Share (%) of the traced window in which the device was idle while the
host was inside the engine's ``launch`` span (the Python enqueue of the
model step): the idle stretches of the device trace (no operation
running, within the window) intersected exactly with the ``launch``
spans of the span log that the engine's ``stats()`` held at the window's
close (``trace_spans``, nanoseconds on the profiler's clock), over the
window.  A program without the log has nothing to read."""
from bench.harness import trace as trace_lib


def _overlap(a, b):
    """Length of the intersection of two sorted lists of disjoint
    (start, end) intervals."""
    tot, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            tot += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def read(run):
    tr, log = run.trace, run.stats_close.get("trace_spans")
    if tr is None or log is None or tr.window_s <= 0:
        return None
    idle = trace_lib.gaps(((s, e) for _, s, e in tr.ops), tr.lo, tr.hi)
    launch = sorted((s / 1e9, e / 1e9) for n, s, e, _ in log
                    if n == "launch")
    return 100.0 * _overlap(idle, launch) / tr.window_s
