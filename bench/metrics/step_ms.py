"""Mean wall time, in ms, of the window's ``engine.step()`` calls (host
clock around each call; the step reads its greedy tokens back, so it
ends with the device)."""


def read(run):
    if not run.steps:
        return None
    return 1e3 * sum(s.t1 - s.t0 for s in run.steps) / len(run.steps)
