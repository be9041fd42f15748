"""Host self time, in ms a step, of the Python enqueue of the model step
(the device idles here only while the host queues kernels slower than
they run).  The window's change in the engine's
``stats()["span_s.launch"]`` over its change in ``steps``; a program
without the span has nothing to read."""

KEYS = ("span_s.launch",)


def read(run):
    a, b = run.stats_open, run.stats_close
    if any(k not in a or k not in b for k in KEYS):
        return None
    steps = b["steps"] - a["steps"]
    if steps <= 0:
        return None
    return 1e3 * sum(b[k] - a[k] for k in KEYS) / steps
