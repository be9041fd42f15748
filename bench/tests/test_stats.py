"""Percentiles and the latency arithmetic, worked by hand."""
from types import SimpleNamespace as R

from bench.harness import stats


def test_nearest_rank_percentile():
    v = list(range(1, 101))             # 1 .. 100
    assert stats.percentile(v, 95) == 95
    assert stats.percentile(v, 50) == 50
    assert stats.percentile(v, 100) == 100
    assert stats.percentile([7.0], 95) == 7.0
    assert stats.percentile([3, 1, 2], 95) == 3
    assert stats.percentile([], 95) is None
    # 20 values: the 95th is the 19th smallest
    assert stats.percentile(range(20), 95) == 18


def test_ttft_counts_unanswered_with_their_wait():
    reqs = [R(due=1.0, first=1.5), R(due=2.0, first=None),
            R(due=0.5, first=0.6),              # due before the window
            R(due=9.0, first=None)]             # due after it
    got = stats.ttfts(reqs, t_close=4.0, window=(1.0, 5.0))
    assert sorted(got) == [0.5, 2.0]
    assert stats.percentile(got, 95) == 2.0


def test_tpot_of_requests_finished_in_the_window():
    reqs = [R(first=1.0, last=2.0, done=2.0, n_tokens=11),
            R(first=1.0, last=1.0, done=1.0, n_tokens=1),     # one token
            R(first=0.0, last=9.0, done=9.0, n_tokens=4),     # after
            R(first=2.0, last=3.0, done=None, n_tokens=5)]    # unfinished
    assert stats.tpots(reqs, (0.5, 5.0)) == [0.1]
