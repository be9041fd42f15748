"""Host self time, in ms a step, of building the batch and uploading it:
the flat (or rectangular) batch, the block tables, the tiles, every
metadata array of the step and its tokens.  The window's change in the
engine's ``stats()["span_s.prepare"]`` over its change in ``steps``; a
program without the span has nothing to read."""

KEYS = ("span_s.prepare",)


def read(run):
    a, b = run.stats_open, run.stats_close
    if any(k not in a or k not in b for k in KEYS):
        return None
    steps = b["steps"] - a["steps"]
    if steps <= 0:
        return None
    return 1e3 * sum(b[k] - a[k] for k in KEYS) / steps
