"""Device time, in ms, of the MoE router kernel family (softmax, top-k
and its sort, the capacity cumsum, the one-hot) per window step, from
the device trace.  Nothing to read without an MoE layer."""


def read(run):
    if run.trace is None or not run.moe or not run.steps:
        return None
    t = run.trace.family_s("router", True)
    return None if t <= 0 else 1e3 * t / len(run.steps)
