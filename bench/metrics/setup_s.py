"""Seconds from the start of the process to the window's opening:
imports, weights, engine, kernel builds on a checkout's first run, the
bucket warm-up, the shared contexts' prefill and the warm traffic."""


def read(run):
    return run.setup_s
