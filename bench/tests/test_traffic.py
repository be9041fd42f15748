"""The generator: the same requests from the same seed, within the mix's
ranges, and the same work for every seed."""
import json
from collections import Counter

import numpy as np
import pytest

from bench.harness import traffic
from bench.tests.smoke import BENCH, CLOSED, OPEN

MIXES = sorted((BENCH / "mixes").glob("*.json"))


def _sig(specs):
    return [(s.prompt.tolist(), s.max_new, round(s.due, 9), s.context)
            for s in specs]


@pytest.mark.parametrize("mix", [OPEN, CLOSED], ids=["open", "closed"])
def test_same_seed_same_requests(mix):
    a = traffic.Traffic(mix, 512, 2 ** 40 + 3).take(300)
    b = traffic.Traffic(mix, 512, 2 ** 40 + 3).take(300)
    c = traffic.Traffic(mix, 512, 7).take(300)
    assert _sig(a) == _sig(b)
    assert _sig(a) != _sig(c)


@pytest.mark.parametrize("path", MIXES, ids=[p.stem for p in MIXES])
def test_mix_ranges_and_fit(path):
    mix = json.loads(path.read_text())
    traffic.check_fits(mix, mix["engine"]["cache_len"])
    t = traffic.Traffic(mix, 1000, 123456789012)
    specs = t.take(traffic.BLOCK)
    news = [s.max_new for s in specs]
    assert mix["max_new"]["low"] <= min(news)
    assert max(news) <= mix["max_new"]["high"]
    if "contexts" in mix:
        c = mix["contexts"]
        assert len(t.contexts) == c["count"]
        for ctx in t.contexts:
            assert c["tokens"]["low"] <= len(ctx) <= c["tokens"]["high"]
            assert len(ctx) % c["tokens"].get("block", 1) == 0
        sfx = mix["suffix_tokens"]
        for s in specs:
            n = len(s.prompt) - len(t.contexts[s.context])
            assert sfx["low"] <= n <= sfx["high"]
            assert n % sfx.get("block", 1) == 0
            assert np.array_equal(s.prompt[:len(t.contexts[s.context])],
                                  t.contexts[s.context])
    else:
        r = mix["prompt_tokens"]
        assert all(r["low"] <= len(s.prompt) <= r["high"] for s in specs)
    assert all(0 <= int(s.prompt.min()) and int(s.prompt.max()) < 1000
               for s in specs)
    if mix["loop"] == "open":
        dues = np.array([s.due for s in specs])
        assert np.all(np.diff(dues) > 0)


@pytest.mark.parametrize("mix", [OPEN, CLOSED], ids=["open", "closed"])
def test_every_seed_sends_the_same_sizes(mix):
    def sizes(seed):
        specs = traffic.Traffic(mix, 512, seed).take(traffic.BLOCK)
        return (Counter(s.max_new for s in specs),
                Counter(len(s.prompt) for s in specs))
    (n1, p1), (n2, p2) = sizes(1), sizes(99)
    assert n1 == n2
    if "contexts" not in mix:
        assert p1 == p2


def test_zipf_counts():
    c = traffic.zipf_counts(16, 1.1, 256)
    assert c.sum() == 256
    assert list(c) == sorted(c, reverse=True)
    w = 1 / np.arange(1, 17) ** 1.1
    assert np.all(np.abs(c - w / w.sum() * 256) < 1)


def test_open_loop_arrivals_are_poisson():
    """Exponential gaps at the mix's rate: mean 1 / rate, coefficient of
    variation 1, and counts in one-second spans as variable as their
    mean (index of dispersion 1)."""
    n = 8000
    dues = np.array([s.due for s in
                     traffic.Traffic(OPEN, 512, 2 ** 31 + 11).take(n)])
    gaps = np.diff(np.concatenate([[0.0], dues]))
    rate = OPEN["rate_rps"]
    assert abs(gaps.mean() * rate - 1) < 0.05
    assert abs(gaps.std() / gaps.mean() - 1) < 0.05
    counts = np.bincount(dues.astype(np.int64))[:-1]
    assert abs(counts.var() / counts.mean() - 1) < 0.15


def test_arrivals_leave_the_sizes_alone():
    """The arrival stream is the seed's own: the requests' sizes and
    tokens are those a closed loop of the same seed would send."""
    closed = dict(OPEN, loop="closed", clients=2)
    a = traffic.Traffic(OPEN, 512, 77).take(64)
    b = traffic.Traffic(closed, 512, 77).take(64)
    assert [(s.prompt.tolist(), s.max_new) for s in a] == \
        [(s.prompt.tolist(), s.max_new) for s in b]


def test_a_mix_that_cannot_fit_is_refused():
    with pytest.raises(ValueError):
        traffic.check_fits(CLOSED, 64)
