"""The whole step's share (%) of the card's bf16 peak: the useful FLOPs
of the window's steps (``bench/harness/account.py``: 2 x active
parameters x the rows kept, plus their attention; no MoE capacity slots
or dispatch) over 989e12 x the steps' total wall time."""
from bench.harness import account


def read(run):
    if not run.steps:
        return None
    wall = sum(s.t1 - s.t0 for s in run.steps)
    flops = sum(account.useful_flops(run.cfg, s.segments) for s in run.steps)
    return 100.0 * flops / (account.PEAK_FLOPS * wall)
