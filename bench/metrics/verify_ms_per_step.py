"""Host self time, in ms a step, of the bookkeeping after the step: draft
acceptance, emission, rewinds, finished and shed requests (the client's
``on_token`` callback is a span of its own).  The window's change in the
engine's ``stats()["span_s.verify"]`` over its change in ``steps``; a
program without the span has nothing to read."""

KEYS = ("span_s.verify",)


def read(run):
    a, b = run.stats_open, run.stats_close
    if any(k not in a or k not in b for k in KEYS):
        return None
    steps = b["steps"] - a["steps"]
    if steps <= 0:
        return None
    return 1e3 * sum(b[k] - a[k] for k in KEYS) / steps
