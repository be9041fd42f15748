"""Host self time, in ms a step, of reading the greedy tokens back: the
host waits here for the device to finish the step.  The window's change
in the engine's ``stats()["span_s.readback"]`` over its change in
``steps``; a program without the span has nothing to read."""

KEYS = ("span_s.readback",)


def read(run):
    a, b = run.stats_open, run.stats_close
    if any(k not in a or k not in b for k in KEYS):
        return None
    steps = b["steps"] - a["steps"]
    if steps <= 0:
        return None
    return 1e3 * sum(b[k] - a[k] for k in KEYS) / steps
