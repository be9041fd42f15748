"""Share (%) of the traced window in which the device was idle while the
host was inside an engine ``step`` span but in none of its children:
the idle stretches of the device trace (no operation running, within
the window) intersected exactly with the ``step`` spans less every other
span of the span log that the engine's ``stats()`` held at the window's
close (``trace_spans``, nanoseconds on the profiler's clock), over the
window.  What the spans leave unexplained; a program without the log has
nothing to read."""
from bench.harness import trace as trace_lib


def _union(intervals):
    """Sorted disjoint (start, end) intervals covering ``intervals``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _minus(a, b):
    """``a`` less ``b``, both sorted lists of disjoint intervals."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        cur, k = s, j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > cur:
                out.append((cur, b[k][0]))
            cur = max(cur, b[k][1])
            k += 1
        if cur < e:
            out.append((cur, e))
    return out


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
    steps = _union((s / 1e9, e / 1e9) for n, s, e, _ in log if n == "step")
    kids = _union((s / 1e9, e / 1e9) for n, s, e, _ in log if n != "step")
    return 100.0 * _overlap(idle, _minus(steps, kids)) / tr.window_s
