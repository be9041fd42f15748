"""The harness's clients: they drive ``PagedDecodeEngine`` through
``submit`` and ``step`` in one thread, on the wall clock, and read
tokens through ``on_token``.

Every request is stamped with its due time (open loop: its place in the
arrival schedule; closed loop: the moment its client sent it), its
submit time, and the time of each token as ``on_token`` hands it over.
Every step is stamped with its start and end and the segments it
computed (``account.Segment``), worked out from the decision ``step``
returns and the tokens it emitted.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from bench.harness import account


@dataclasses.dataclass(eq=False)
class ReqRec:
    rid: int
    prompt: np.ndarray
    max_new: int
    due: float
    submit: float
    tokens: List[int] = dataclasses.field(default_factory=list)
    first: Optional[float] = None
    last: Optional[float] = None
    done: Optional[float] = None

    @property
    def n_tokens(self) -> int:
        return len(self.tokens)


@dataclasses.dataclass
class SegDetail:
    """A segment as the check replays it: the request, its lane, its
    first position, the tokens it fed (then its drafts) and the tokens it
    emitted."""
    rid: int
    lane: int
    start: int
    fed: List[int]
    drafts: List[int]
    emitted: List[int]


@dataclasses.dataclass
class StepRec:
    t0: float
    t1: float
    segments: List[account.Segment]
    emitted: int
    scheduled: int
    detail: Optional[List[SegDetail]] = None


class Driver:
    """Submits requests to ``engine`` and steps it, recording both."""

    def __init__(self, engine, clock: Callable[[], float] = time.perf_counter,
                 keep_steps: bool = True):
        self.engine = engine
        self.clock = clock
        self.reqs: Dict[int, ReqRec] = {}
        self.steps: List[StepRec] = []
        self.keep_steps = keep_steps
        self._emitted: Dict[int, int] = {}
        self.finished_now: List[ReqRec] = []
        engine.on_token = self._on_token

    def _on_token(self, rid: int, tok: int, finished: bool) -> None:
        t = self.clock()
        r = self.reqs.get(rid)
        if r is None:
            return
        r.tokens.append(int(tok))
        if r.first is None:
            r.first = t
        r.last = t
        self._emitted[rid] = self._emitted.get(rid, 0) + 1
        if finished:
            r.done = t
            self.finished_now.append(r)

    def submit(self, prompt: np.ndarray, max_new: int, due: float) -> ReqRec:
        rid = self.engine.submit(prompt, max_new)
        rec = ReqRec(rid=rid, prompt=prompt, max_new=max_new, due=due,
                     submit=self.clock())
        self.reqs[rid] = rec
        return rec

    def step(self, detail: bool = False) -> StepRec:
        """One ``engine.step()``; with ``detail`` the segments' lanes and
        tokens too (the check's replay reads them)."""
        self._emitted = {}
        self.finished_now = []
        lanes = ({r.request_id: r.lane for r in
                  self.engine.scheduler.running} if detail else {})
        t0 = self.clock()
        decision = self.engine.step()
        t1 = self.clock()
        segs: List[account.Segment] = []
        details: List[SegDetail] = []
        for r in decision.scheduled:
            n = decision.num_scheduled[r.request_id]
            drafts = list(decision.drafts.get(r.request_id, ()))
            k = len(drafts)
            e = self._emitted.get(r.request_id, 0)
            if e == 0:                      # a prefill chunk mid-prompt
                start, useful = r.cursor - n, n
            else:                           # fed rows, then the drafts
                start = len(r.feed) - e - (n - k)
                useful = n - k + min(e - 1, k)
            segs.append((start, n, useful))
            if detail:
                rec = self.reqs[r.request_id]
                full = [int(t) for t in rec.prompt] + rec.tokens
                details.append(SegDetail(
                    rid=r.request_id, lane=lanes.get(r.request_id, r.lane),
                    start=start, fed=full[start:start + n - k],
                    drafts=drafts, emitted=rec.tokens[len(rec.tokens) - e:]))
        rec = StepRec(t0=t0, t1=t1, segments=segs,
                      emitted=sum(self._emitted.values()),
                      scheduled=sum(n for _, n, _ in segs),
                      detail=details if detail else None)
        if self.keep_steps:
            self.steps.append(rec)
        return rec

    def drain(self, limit_s: float = 600.0) -> None:
        """Step until the engine has no work (set-up phases)."""
        t_end = self.clock() + limit_s
        while self.engine.has_work():
            if self.clock() > t_end:
                raise RuntimeError("the engine did not drain in "
                                   f"{limit_s} s")
            self.step()
