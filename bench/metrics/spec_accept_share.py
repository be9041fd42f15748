"""Share (%) of the window's drafted tokens that verification accepted:
the window's change in ``stats()["draft_tokens_accepted"]`` over that
in ``stats()["tokens_drafted"]``.  Nothing to read when nothing was
drafted."""


def read(run):
    drafted = (run.stats_close["tokens_drafted"]
               - run.stats_open["tokens_drafted"])
    if drafted <= 0:
        return None
    got = (run.stats_close["draft_tokens_accepted"]
           - run.stats_open["draft_tokens_accepted"])
    return 100.0 * got / drafted
