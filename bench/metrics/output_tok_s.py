"""Tokens emitted by the window's steps over the window's seconds."""


def read(run):
    t0, t1 = run.window
    return sum(s.emitted for s in run.steps) / (t1 - t0)
