"""Host self time, in ms a step, of the host swap tier: the synchronous
device-to-host payload copies of evicted blocks (span ``swap_out``) and
the host-to-device writes of swapped-in ones, with the tier's trimming
(``swap_in``).  The window's change in the engine's
``stats()["span_s.swap_out"] + stats()["span_s.swap_in"]`` over its
change in ``steps``; a program without the spans has nothing to read."""

KEYS = ("span_s.swap_out", "span_s.swap_in")


def read(run):
    a, b = run.stats_open, run.stats_close
    if any(k not in a or k not in b for k in KEYS):
        return None
    steps = b["steps"] - a["steps"]
    if steps <= 0:
        return None
    return 1e3 * sum(b[k] - a[k] for k in KEYS) / steps
