"""Mean wait, in ms, of the requests first admitted in the window, from
their submit to their first admission into a lane (re-admissions after
preemption left out): the window's change in the engine's
``stats()["queue_wait_s"]`` over its change in ``stats()["admitted"]``.
A program without the counters has nothing to read."""

KEYS = ("queue_wait_s", "admitted")


def read(run):
    a, b = run.stats_open, run.stats_close
    if any(k not in a or k not in b for k in KEYS):
        return None
    n = b["admitted"] - a["admitted"]
    return None if n <= 0 else 1e3 * (b["queue_wait_s"]
                                      - a["queue_wait_s"]) / n
