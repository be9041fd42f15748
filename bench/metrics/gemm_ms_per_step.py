"""Device time, in ms, of the GEMM kernel family per window step, from
the device trace."""


def read(run):
    if run.trace is None or not run.steps:
        return None
    t = run.trace.family_s("gemm", run.moe)
    return None if t <= 0 else 1e3 * t / len(run.steps)
