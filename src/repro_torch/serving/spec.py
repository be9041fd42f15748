"""Draft-token proposers for speculative multi-token decode.

Host-only: a copy of the reference package's ``serving/spec.py``.

The serving engine's speculative path amortizes the memory-bound decode
step: instead of one model step per generated token per lane, a *proposer*
guesses ``k`` candidate tokens for each decode lane, the lane is scheduled
as one ``1 + k``-token ragged segment (the same multi-token segments the
chunked-prefill path already runs), and the single model step's
per-position greedy argmax verifies the guesses — the longest matching
draft prefix is accepted plus one *bonus* token (the argmax at the first
mismatching / final row).  Verification is exact: greedy outputs are
token-identical to the non-speculative engine whatever the proposer
emits, so proposers only trade compute for acceptance rate, never
correctness.

:class:`NgramProposer` is the model-free default (vLLM's n-gram /
prompt-lookup idea): the continuation is guessed from the request's *own*
token history, which is free and surprisingly effective on the
structured, self-repeating outputs long generations settle into.  A small
draft *model* can slot in behind the same :class:`Proposer` interface
later — the scheduler/engine contract only needs ``propose``.
"""
from __future__ import annotations

from typing import List, Sequence


class Proposer:
    """Interface: guess up to ``k`` continuation tokens for one request.

    ``tokens`` is the request's full known history (prompt + generated so
    far, the engine's ``feed``); the return value is a list of at most
    ``k`` draft token ids extending it.  Proposals may be arbitrarily
    wrong — the engine verifies every draft against the model's own
    greedy argmax before accepting — so implementations should optimize
    acceptance rate, not worst-case safety.  An empty list means "no
    guess": the lane falls back to plain one-token decode this step.
    """

    def propose(self, tokens: Sequence[int], k: int) -> List[int]:
        """Return up to ``k`` draft token ids extending ``tokens``."""
        raise NotImplementedError


class NgramProposer(Proposer):
    """Model-free n-gram / prompt-lookup proposer.

    Finds the most recent earlier occurrence of the history's final
    n-gram (longest ``n`` first, ``max_ngram`` down to ``min_ngram``) and
    proposes the tokens that followed it.  Repetitive or templated
    continuations — looping generations, copied spans, structured
    records — match long n-grams and get near-full acceptance; histories
    with no self-match propose nothing and cost nothing.

    ``lookback`` caps how far back the match scan reaches, so the
    per-step host cost stays O(lookback * max_ngram) instead of growing
    quadratically with the generation length.
    """

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1,
                 lookback: int = 1024) -> None:
        """Set the n-gram match range and the history scan window."""
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"({min_ngram}, {max_ngram})")
        if lookback < 2:
            raise ValueError(f"lookback must be >= 2, got {lookback}")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        self.lookback = lookback

    def propose(self, tokens: Sequence[int], k: int) -> List[int]:
        """Prompt-lookup: propose what followed the last matching n-gram."""
        toks = [int(t) for t in tokens[-self.lookback:]]
        n_hist = len(toks)
        if k <= 0 or n_hist < self.min_ngram + 1:
            return []
        for n in range(min(self.max_ngram, n_hist - 1),
                       self.min_ngram - 1, -1):
            tail = toks[n_hist - n:]
            # most recent earlier occurrence wins (recent context is the
            # best predictor of what follows the pattern this time) —
            # except that a match hugging the tail has fewer than k
            # followers, so the most recent match with a FULL k-token
            # continuation is preferred: on a period-p loop that turns
            # "propose p tokens" into "propose k tokens", the whole win.
            # A match always has >= 1 follower (it ends before the tail).
            fallback: List[int] = []
            for start in range(n_hist - n - 1, -1, -1):
                if toks[start:start + n] == tail:
                    if n_hist - start - n >= k:
                        return toks[start + n:start + n + k]
                    if not fallback:
                        fallback = toks[start + n:start + n + k]
            if fallback:
                return fallback
        return []
