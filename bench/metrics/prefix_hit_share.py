"""Share (%) of the prompt tokens submitted in the window that the
prefix cache served: the window's change in the engine's
``stats()["prefix_tokens_reused"]`` over those prompt tokens."""


def read(run):
    sent = sum(len(r.prompt) for r in run.window_reqs)
    if not sent:
        return None
    got = (run.stats_close["prefix_tokens_reused"]
           - run.stats_open["prefix_tokens_reused"])
    return 100.0 * got / sent
