"""The one traffic generator: a mix file of ``bench/mixes/`` in, request
specifications out.

Every size is drawn stratified: a block of ``BLOCK`` requests takes the
values of its distribution at the block's evenly spaced quantiles, and
the seed only shuffles them and picks the token ids.  So every seed
sends the same work in another order, and two seeds differ by the order
and by what the tokens make the model do, not by how much is asked.
The block is short (32 requests) because a run sends only about a
hundred requests in some cells: with blocks of 256, the part of a block
that one run reached differed from seed to seed, and the runs of
different seeds spread several times wider than two runs of one seed.

Open-loop arrivals are not stratified: they are a Poisson process at
``rate_rps`` (independent exponential gaps, drawn from a stream of the
seed of their own), so the counts in any span vary as users' do.

Mix keys read here (see ``bench/README.md``):

* ``loop``: ``"open"`` (arrivals on a schedule, at ``rate_rps``) or
  ``"closed"`` (``clients`` clients, each sending its next request when
  its last one finishes);
* ``prompt_tokens`` or, with ``contexts``, ``suffix_tokens``: a range
  ``{"low", "high", "dist": "uniform" | "loguniform", "block": n}``
  (``block`` rounds lengths down to whole multiples);
* ``contexts``: ``{"count", "tokens": range, "zipf_s"}`` shared contexts
  (repositories, documents), prefilled in set-up; a request takes one by
  Zipf and appends its own suffix;
* ``max_new``: a range of output lengths.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, List

import numpy as np

BLOCK = 32


@dataclasses.dataclass
class Spec:
    """One request: its prompt, its output length, and (open loop) when
    it is due, in seconds from the start of the traffic."""
    prompt: np.ndarray
    max_new: int
    due: float = 0.0
    context: int = -1


def _quantiles(r: Dict, n: int) -> np.ndarray:
    u = (np.arange(n) + 0.5) / n
    lo, hi = float(r["low"]), float(r["high"])
    if r.get("dist", "uniform") == "loguniform":
        v = np.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    else:
        v = lo + u * (hi - lo)
    v = np.floor(v).astype(np.int64)
    blk = int(r.get("block", 1))
    if blk > 1:
        v = (v // blk) * blk
    return np.clip(v, int(lo), int(hi))


def zipf_counts(n_items: int, s: float, n: int) -> np.ndarray:
    """How many of ``n`` draws fall on each of ``n_items`` items under a
    Zipf law of exponent ``s``, by largest remainders (sums to ``n``)."""
    w = 1.0 / np.arange(1, n_items + 1) ** s
    exact = w / w.sum() * n
    counts = np.floor(exact).astype(np.int64)
    order = np.argsort(-(exact - counts), kind="stable")
    counts[order[:n - counts.sum()]] += 1
    return counts


class Traffic:
    """The requests of one mix under one seed."""

    def __init__(self, mix: Dict, vocab: int, seed: int):
        self.mix = mix
        self.vocab = int(vocab)
        self.rng = np.random.default_rng(int(seed))
        self.arrivals = np.random.default_rng([int(seed), 1])
        self.loop = mix["loop"]
        if self.loop not in ("open", "closed"):
            raise ValueError(f"loop must be open or closed, got {self.loop}")
        self.contexts: List[np.ndarray] = []
        if "contexts" in mix:
            c = mix["contexts"]
            lens = self.rng.permutation(_quantiles(c["tokens"], c["count"]))
            self.contexts = [self._tokens(n) for n in lens]

    def _tokens(self, n: int) -> np.ndarray:
        return self.rng.integers(0, self.vocab, int(n)).astype(np.int32)

    def _block(self) -> List[Spec]:
        m, n = self.mix, BLOCK
        news = self.rng.permutation(_quantiles(m["max_new"], n))
        if self.contexts:
            c = m["contexts"]
            ctx = np.repeat(np.arange(len(self.contexts)),
                            zipf_counts(len(self.contexts), c["zipf_s"], n))
            ctx = self.rng.permutation(ctx)
            sfx = self.rng.permutation(_quantiles(m["suffix_tokens"], n))
            return [Spec(np.concatenate([self.contexts[int(ctx[i])],
                                         self._tokens(sfx[i])]),
                         int(news[i]), context=int(ctx[i]))
                    for i in range(n)]
        lens = self.rng.permutation(_quantiles(m["prompt_tokens"], n))
        return [Spec(self._tokens(lens[i]), int(news[i])) for i in range(n)]

    def requests(self) -> Iterator[Spec]:
        """The endless stream of requests, in sending order; open-loop
        ones carry their due times (Poisson arrivals at ``rate_rps``)."""
        t = 0.0
        rate = float(self.mix.get("rate_rps", 0.0))
        while True:
            block = self._block()
            if self.loop == "open":
                gaps = self.arrivals.exponential(1.0 / rate, BLOCK)
                for spec, g in zip(block, gaps):
                    t += float(g)
                    spec.due = t
            yield from block

    def take(self, n: int) -> List[Spec]:
        it = self.requests()
        return [next(it) for _ in range(n)]


def check_fits(mix: Dict, cache_len: int) -> None:
    """Refuse a mix whose longest request cannot fit one lane's cache."""
    if "contexts" in mix:
        longest = mix["contexts"]["tokens"]["high"] + \
            mix["suffix_tokens"]["high"]
    else:
        longest = mix["prompt_tokens"]["high"]
    longest += mix["max_new"]["high"]
    if longest > cache_len:
        raise ValueError(f"the mix's longest request, {longest} tokens, "
                         f"does not fit cache_len {cache_len}")
