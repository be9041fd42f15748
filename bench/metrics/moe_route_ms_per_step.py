"""Device time, in ms a step, of the MoE layers' route stage (softmax,
top-k, one-hot, capacity cumsum), from the CUDA events the program
records at the stage's boundaries in a traced step: the window's change
in the engine's ``stats()["moe_ms.route"]`` over its change in
``moe_traced_steps``.  A stage's time is its elapsed time on the stream,
launch gaps included.  Nothing to read without an MoE layer, or from a
program without the stage events."""

KEY, STEPS = "moe_ms.route", "moe_traced_steps"


def read(run):
    a, b = run.stats_open, run.stats_close
    if any(k not in a or k not in b for k in (KEY, STEPS)):
        return None
    steps = b[STEPS] - a[STEPS]
    return None if steps <= 0 else (b[KEY] - a[KEY]) / steps
