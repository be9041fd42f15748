"""Continuous-batching scheduler over the paged KV pool.

Host-only (numpy + stdlib): a near-verbatim copy of the reference
package's ``serving/scheduler.py``; the differential tests require equal
:class:`StepDecision` sequences from both under the same traces.

Every engine step is one **token-budgeted batch** that freely mixes
multi-token prefill chunks and single-token decodes — there is no
prefill/decode phase split.  Each step the scheduler assigns every request
a ``num_scheduled_tokens`` count under one shared budget:

  * **decode** lanes (next step emits a new token) are served first at one
    token each — cheap, so a flood of long prompts can never starve them;
    with a speculative :class:`~repro_torch.serving.spec.Proposer` wired
    (``draft_k > 0``) a decode lane additionally schedules up to ``k``
    draft tokens as one ``1 + k``-token segment (the engine verifies them
    against the model's own argmax in the same step); drafted tokens count
    against the step's token budget like any other scheduled token, but a
    rejected draft never advances the request — one budget token is
    reserved per still-unserved decode lane, per running prefill lane,
    and per pending admission with a free lane, so drafts can never
    starve a sibling decode, stall a mid-prompt request, or gate
    admissions indefinitely;
  * **prefill** lanes (still consuming their prompt / replaying after
    preemption) take chunks of up to ``chunk_tokens`` from the remaining
    budget — a long prompt is consumed in a few chunked steps instead of
    one step per token;
  * **admission**: waiting requests are admitted into free lanes while the
    budget holds and the KV manager can cover their feed; with the prefix
    cache on, admission shares the longest chain of cached full blocks
    (``KVCacheManager.begin_seq``) so identical preambles are never
    re-prefilled;
  * **preemption by recompute**: when the pool runs out of blocks mid-step,
    the latest-admitted request is evicted — its blocks are freed and it
    re-enters the waiting queue with its generated tokens intact, to be
    replayed (prefill-as-recompute) once memory frees up.  If the victim
    would be the request currently being guaranteed and it already secured
    part of its chunk, the chunk is truncated instead (mid-chunk
    preemption): partial progress is kept and the step proceeds.  Greedy
    decode is deterministic, so replays reproduce the identical
    continuation.  With the engine's host swap tier installed
    (``KVCacheManager.on_swap_out``) preemption degrades to **swap-out**:
    the victim's registered full blocks stay recoverable (device prefix
    cache first, spilling to the host pool under pressure) and its
    re-admission swaps them back in instead of recomputing them.
"""
from __future__ import annotations

import dataclasses
import enum
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

import numpy as np

from repro_torch.serving.blocks import KVCacheManager


class RequestState(enum.Enum):
    """Lifecycle of a request: waiting -> running (-> waiting again on
    preemption) -> finished."""

    WAITING = "waiting"
    RUNNING = "running"
    FINISHED = "finished"


@dataclasses.dataclass(eq=False)          # identity semantics for in/remove
class Request:
    """One serving request plus its engine-internal progress state.

    ``feed`` is the token stream still to be pushed through the model
    (prompt + generated-so-far after a preemption replay); ``cursor`` the
    next feed index, i.e. how many of its tokens already sit in KV.
    """

    request_id: int
    prompt: np.ndarray               # (prompt_len,) int32
    max_new_tokens: int
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # priority class: higher admits first and is preempted last; ties
    # keep FIFO order, so the default 0 reproduces plain FIFO serving
    priority: int = 0
    # terminal disposition beyond plain completion: ``cancelled`` marks a
    # mid-flight abort (engine.cancel / a disconnected stream), ``shed``
    # an SLO admission drop — both are surfaced through the engine's
    # finished list with ``done=True`` and no further tokens
    cancelled: bool = False
    shed: bool = False
    # --- engine-internal state ---
    state: RequestState = RequestState.WAITING
    feed: List[int] = dataclasses.field(default_factory=list)
    cursor: int = 0                  # next feed index == tokens already in KV
    lane: Optional[int] = None
    n_preemptions: int = 0
    # --- latency accounting (stamped from the engine's clock: wall time,
    # or the shared SimClock in disaggregated / open-loop runs) ---
    t_submit: float = 0.0
    t_admit: float = 0.0             # first admission (not a re-admission)
    t_first_token: float = 0.0
    t_done: float = 0.0

    def begin_run(self, lane: int) -> None:
        """(Re)admission: the feed is prompt + generated-so-far; after a
        preemption the generated suffix is recomputed deterministically.
        The cursor may then be advanced past a cached shared prefix."""
        self.feed = [int(t) for t in self.prompt] + list(self.generated)
        self.cursor = 0
        self.lane = lane
        self.state = RequestState.RUNNING

    @property
    def is_decode(self) -> bool:
        """True when the next step emits a new token (vs prompt prefill)."""
        return self.cursor >= len(self.feed) - 1

    @property
    def remaining_feed(self) -> int:
        """Feed tokens not yet pushed through the model."""
        return len(self.feed) - self.cursor


@dataclasses.dataclass
class SchedulerConfig:
    """Scheduler knobs: lane count, token budget, chunking, speculation.

    See the field comments for each knob's semantics; the module
    docstring describes how they interact in one step.
    """

    n_lanes: int
    token_budget: int = 0    # 0 = n_lanes * chunk_tokens
    chunk_tokens: int = 1    # per-request tokens per step cap; 0 = unlimited
    # ragged flat-token mode: after the normal pass, extend prefill chunks
    # until the step's total token count reaches its pow2 bucket boundary
    # (capped at the budget) — the flat slots the bucket would otherwise
    # waste on padding carry real prefill work instead.  The per-segment
    # view of the resulting stream (cu_seqlens, per-segment lane/position,
    # and the segment-tiled TileMap the tiled attention grid consumes) is
    # derived from the decision by serving/batch.py — one segment per
    # scheduled request, so a step never has more segments than lanes.
    fill_to_bucket: bool = False
    # speculative decode: when a proposer is set and draft_k > 0, each
    # decode lane is offered up to draft_k draft tokens per step (see the
    # module docstring for the budget interaction)
    draft_k: int = 0
    proposer: Optional[object] = None      # repro_torch.serving.spec.Proposer
    # SLO-aware admission (0 = off).  ``tpot_target`` (seconds per decode
    # token): while the observed decode TPOT (EWMA fed by
    # :meth:`Scheduler.observe_step`) sits above target, prefill chunks
    # shrink by powers of two (staying inside the engine's compiled chunk
    # buckets) and bucket-filling is suppressed, trading new-request
    # prefill bandwidth for in-flight decode latency.  ``ttft_target``
    # (seconds): a waiting request whose first-token deadline has already
    # passed is shed at admission time instead of burning prefill compute
    # on a request that can no longer meet its SLO (``slo_shed=False``
    # keeps the chunk-shrink behaviour but never drops requests).
    ttft_target: float = 0.0
    tpot_target: float = 0.0
    slo_shed: bool = True


@dataclasses.dataclass
class StepDecision:
    """One step's scheduling outcome: who runs, with how many tokens.

    The engine turns this into a :class:`~repro_torch.serving.batch.RaggedBatch`
    (or a rectangular batch) — one segment per scheduled request.
    """

    scheduled: List[Request]
    # request_id -> tokens scheduled this step (>= 1 for every scheduled
    # request; decode lanes get 1 + their draft count)
    num_scheduled: Dict[int, int] = dataclasses.field(default_factory=dict)
    # request_id -> this step's speculative draft tokens (decode lanes
    # only; absent = no drafts).  A lane's scheduled segment is its feed
    # slice followed by these drafts — num_scheduled counts both.
    drafts: Dict[int, List[int]] = dataclasses.field(default_factory=dict)
    n_prefill: int = 0
    n_decode: int = 0
    n_prefill_tokens: int = 0
    n_decode_tokens: int = 0
    n_draft_tokens: int = 0          # drafted tokens scheduled this step
    n_admitted: int = 0
    n_preempted: int = 0
    # preemptions that degraded to swap-outs: the victim's registered full
    # blocks stay recoverable (device prefix cache, spilling to the host
    # tier under pressure), so its resume swaps KV back in instead of
    # recomputing it.  Counted within n_preempted, not in addition to it.
    n_swapped_out: int = 0
    prefix_cached_tokens: int = 0    # feed tokens skipped via prefix sharing

    def segment_tokens(self, req: Request) -> List[int]:
        """The token ids of ``req``'s scheduled segment, in stream order:
        its feed slice, extended by its draft tokens when it is a
        speculative decode lane."""
        n = self.num_scheduled[req.request_id]
        toks = [int(t) for t in req.feed[req.cursor:req.cursor + n]]
        if len(toks) < n:
            toks += self.drafts.get(req.request_id, [])[:n - len(toks)]
        return toks


class Scheduler:
    """Token-budgeted continuous-batching scheduler (see module docstring).

    Owns the waiting queue and the lane assignments; consults the
    :class:`~repro_torch.serving.blocks.KVCacheManager` for admission planning
    and preemption decisions but never touches device state itself.
    """

    def __init__(self, cfg: SchedulerConfig, kv: KVCacheManager) -> None:
        """Bind the scheduler to its config and the KV block manager."""
        self.cfg = cfg
        self.kv = kv
        self.waiting: Deque[Request] = deque()
        self.running: List[Request] = []          # admission (priority) order
        self.lanes: List[Optional[Request]] = [None] * cfg.n_lanes
        self.total_preemptions = 0
        self.total_swap_outs = 0
        self.total_admitted = 0
        self.total_cancelled = 0
        self.total_shed = 0
        # first admissions (re-admissions after preemption left out) and
        # their summed wait from submit
        self.first_admissions = 0
        self.queue_wait_s = 0.0
        # last admission refusal: (request, feed_len, free_blocks, version)
        # — while none of those change, re-asking (and re-hashing a long
        # prompt against the prefix cache) every step is pointless
        self._blocked_state = None
        # SLO state: the engine installs its clock here (SimClock-aware
        # engines stamp sim time; default is wall time) and feeds measured
        # step durations into the decode-TPOT EWMA via observe_step
        self.now_fn: Callable[[], float] = time.perf_counter
        self.tpot_ewma = 0.0
        self._shed: List[Request] = []

    # ------------------------------------------------------------------
    def add(self, req: Request) -> None:
        """Queue a new request for admission (FIFO)."""
        self.waiting.append(req)

    def has_work(self) -> bool:
        """True while any request is waiting or running."""
        return bool(self.waiting or self.running)

    def observe_step(self, seconds: float, decode_tokens: int) -> None:
        """Feed one engine step's measured duration back into the decode
        TPOT estimate (EWMA, alpha 0.3).  ``decode_tokens`` is the number
        of tokens the step emitted; steps that emitted none (pure prefill)
        carry no TPOT signal and are skipped."""
        if decode_tokens <= 0:
            return
        sample = seconds / decode_tokens
        self.tpot_ewma = (sample if self.tpot_ewma == 0.0
                          else 0.7 * self.tpot_ewma + 0.3 * sample)

    def _overloaded(self) -> bool:
        """True while the observed decode TPOT sits above its target."""
        return (self.cfg.tpot_target > 0
                and self.tpot_ewma > self.cfg.tpot_target)

    def take_shed(self) -> List[Request]:
        """Hand off requests SLO admission shed since the last call (the
        engine moves them into its finished list)."""
        out, self._shed = self._shed, []
        return out

    def _chunk(self) -> int:
        chunk = self.cfg.chunk_tokens or 1_000_000_000
        if self._overloaded():
            # halve the prefill chunk per doubling of TPOT overshoot — a
            # pow2 shrink keeps the engine inside its compiled chunk-width
            # buckets, and the floor of 1 preserves prefill liveness
            over = self.tpot_ewma / self.cfg.tpot_target
            while over > 1.0 and chunk > 1:
                chunk //= 2
                over /= 2.0
        return max(chunk, 1)

    def _budget(self) -> int:
        return self.cfg.token_budget or \
            self.cfg.n_lanes * max(1, self.cfg.chunk_tokens)

    # ------------------------------------------------------------------
    def _next_waiting(self) -> int:
        """Index of the next admission candidate: highest priority class
        first, FIFO (and preempted-resume-first) within a class.  When
        every waiting priority is equal this is index 0 — exactly the
        pre-priority admission order."""
        it = iter(self.waiting)
        first = next(it).priority
        if all(r.priority == first for r in it):
            return 0
        return max(range(len(self.waiting)),
                   key=lambda i: (self.waiting[i].priority, -i))

    def _shed_req(self, idx: int) -> None:
        """SLO shed: drop a waiting request whose TTFT deadline already
        passed — admitting it would spend prefill compute on a request
        that can no longer meet its SLO, slowing everyone else."""
        req = self.waiting[idx]
        del self.waiting[idx]
        if self._blocked_state is not None and self._blocked_state[0] is req:
            self._blocked_state = None
        req.state = RequestState.FINISHED
        req.done = True
        req.shed = True
        req.t_done = self.now_fn()
        self._shed.append(req)
        self.total_shed += 1

    def _admit(self, budget_left: int, decision: StepDecision,
               scheduled: List[Request]) -> int:
        while self.waiting and budget_left > 0 and None in self.lanes:
            idx = self._next_waiting()
            req = self.waiting[idx]
            if (self.cfg.ttft_target > 0 and self.cfg.slo_shed
                    and req.t_first_token == 0.0
                    and req.n_preemptions == 0
                    and self.now_fn() - req.t_submit
                    > self.cfg.ttft_target):
                # only never-admitted requests shed: a preempted victim
                # was already accepted (and may hold emitted tokens) —
                # dropping it would break the completion promise
                self._shed_req(idx)
                continue
            state = (req, len(req.prompt) + len(req.generated),
                     self.kv.num_free_blocks,
                     getattr(self.kv, "cache_version", 0))
            if state == self._blocked_state:
                break
            feed = [int(t) for t in req.prompt] + list(req.generated)
            if not self.kv.can_admit(feed):
                self._blocked_state = state
                break
            self._blocked_state = None
            del self.waiting[idx]
            lane = self.lanes.index(None)
            req.begin_run(lane)
            if req.n_preemptions == 0:
                req.t_admit = self.now_fn()
                self.first_admissions += 1
                self.queue_wait_s += req.t_admit - req.t_submit
            self.lanes[lane] = req
            self.running.append(req)
            # share the longest cached prefix; cursor skips past it
            req.cursor = self.kv.begin_seq(req.request_id, req.feed)
            decision.prefix_cached_tokens += req.cursor
            scheduled.append(req)
            n = min(req.remaining_feed, self._chunk(), budget_left)
            decision.num_scheduled[req.request_id] = n
            budget_left -= n
            decision.n_admitted += 1
            self.total_admitted += 1
        return budget_left

    def _preempt(self, victim: Request, decision: StepDecision,
                 scheduled: List[Request]) -> None:
        # with the host swap tier installed, a victim whose full blocks
        # are registered is swapped out rather than recomputed: free()
        # keeps those blocks recoverable through the prefix cache, the
        # eviction hook spills them host-side under pressure, and the
        # victim's re-admission swaps them back in
        if (self.kv.on_swap_out is not None
                and self.kv.seq_swap_preserved(victim.request_id) > 0):
            decision.n_swapped_out += 1
            self.total_swap_outs += 1
        self.kv.free(victim.request_id)
        self.lanes[victim.lane] = None
        victim.lane = None
        victim.state = RequestState.WAITING
        victim.n_preemptions += 1
        self.running.remove(victim)
        if victim in scheduled:
            scheduled.remove(victim)
        decision.num_scheduled.pop(victim.request_id, None)
        decision.drafts.pop(victim.request_id, None)
        self.waiting.appendleft(victim)        # resume as soon as possible
        decision.n_preempted += 1
        self.total_preemptions += 1

    def schedule(self) -> StepDecision:
        """Assign this step's per-request token counts under one budget,
        admit, and guarantee a KV slot for every scheduled token."""
        decision = StepDecision(scheduled=[])
        budget_left = self._budget()
        chunk = self._chunk()
        scheduled: List[Request] = []

        # decodes first (1 token each, plus speculative drafts): never
        # starved by prefill chunks.  Draft budgeting is fair: one budget
        # token is reserved for every decode lane still unserved behind
        # this one (a greedy 1+k segment can never push a sibling decode
        # out of the step, which would otherwise starve it forever — the
        # starved lane stays a decode next step too), for every running
        # prefill lane (drafts never reduce a mid-prompt request below
        # the one-token-per-step progress floor it had before speculation
        # existed), and for one admission when a request is waiting on a
        # free lane (a pure-decode fleet regenerates its decode state
        # every step, so without the reserve full-budget draft segments
        # would gate admissions on a lane finishing).
        decodes = [r for r in self.running if r.is_decode]
        reserve = (len(self.running) - len(decodes)
                   + (1 if self.waiting and None in self.lanes else 0))
        for i, r in enumerate(decodes):
            if budget_left <= 0:
                break
            drafts: List[int] = []
            if self.cfg.proposer is not None and self.cfg.draft_k > 0:
                # cap drafts by the fair budget share, the per-seq KV
                # ceiling (a draft past it could never be appended), and
                # the request's own remaining output (accepting more than
                # remaining - 1 drafts is wasted work: the bonus token
                # already covers the last slot)
                room = (self.kv.max_blocks_per_seq * self.kv.block_size
                        - (r.cursor + 1))
                want = min(self.cfg.draft_k,
                           budget_left - 1 - (len(decodes) - i - 1)
                           - reserve,
                           room, r.max_new_tokens - len(r.generated) - 1)
                if want > 0:
                    drafts = [int(t) for t in
                              self.cfg.proposer.propose(r.feed, want)][:want]
            scheduled.append(r)
            decision.num_scheduled[r.request_id] = 1 + len(drafts)
            if drafts:
                decision.drafts[r.request_id] = drafts
            budget_left -= 1 + len(drafts)
        # prefill chunks from the remaining budget
        for r in self.running:
            if budget_left <= 0:
                break
            if not r.is_decode:
                n = min(r.remaining_feed, chunk, budget_left)
                scheduled.append(r)
                decision.num_scheduled[r.request_id] = n
                budget_left -= n

        budget_left = self._admit(budget_left, decision, scheduled)

        # ragged bucket fill: the flat batch is padded to a pow2 total, so
        # extend prefill chunks (beyond chunk_tokens — the per-lane width
        # cap is meaningless without a rectangle) until the total lands on
        # the bucket boundary: padding slots become real prefill work.
        # Greedy decode is causal per request, so scheduling more prompt
        # tokens per step never changes any output.
        # under TPOT overload the bucket fill is suppressed along with the
        # chunk shrink: both convert spare step capacity into prefill
        # work, which is exactly what is crowding out decode latency
        if self.cfg.fill_to_bucket and decision.num_scheduled \
                and not self._overloaded():
            from repro_torch.serving.batch import padded_pow2
            total = sum(decision.num_scheduled.values())
            spare = min(self._budget(), padded_pow2(total)) - total
            for r in scheduled:
                if spare <= 0:
                    break
                n = decision.num_scheduled[r.request_id]
                extra = min(spare, r.remaining_feed - n)
                if extra > 0:
                    decision.num_scheduled[r.request_id] = n + extra
                    spare -= extra

        # guarantee a KV slot for every scheduled token, in priority order;
        # evict from the back (latest admitted) when the pool runs dry —
        # truncating the current chunk instead when the victim would be the
        # request itself and it already made progress
        for req in [r for r in self.running if r in scheduled]:
            if req not in scheduled:           # evicted by an earlier lane
                continue
            n = decision.num_scheduled[req.request_id]
            toks = decision.segment_tokens(req)
            k = 0
            while k < n:
                self_blocked = False
                # num_free_blocks routes through KVCacheManager.free_blocks,
                # so an LRU block that a live admission plan counted as a
                # prefix hit is NOT treated as free here — evicting it would
                # silently turn the planned hit into a recompute
                while (self.kv.append_needs_block(req.request_id)
                       and self.kv.num_free_blocks == 0):
                    if self.kv.free_blocks(planned=False) > 0:
                        # every reclaimable block is shielding a planned
                        # admission hit: surrender the plan (its owner
                        # re-plans, worst case recomputing the prefix)
                        # before preempting live work
                        self.kv.drop_plan_protection()
                        continue
                    victim = self.running[-1]
                    if any(r.priority != victim.priority
                           for r in self.running):
                        # priority classes: evict the lowest class first,
                        # latest-admitted within a class (min over the
                        # reversed list keeps the default-priority victim
                        # exactly running[-1])
                        victim = min(reversed(self.running),
                                     key=lambda r: r.priority)
                    if victim is req:
                        self_blocked = True
                        break
                    self._preempt(victim, decision, scheduled)
                if self_blocked:
                    if k > 0:                  # mid-chunk: keep progress
                        break
                    if len(self.running) == 1:
                        raise RuntimeError(
                            "KV pool too small for a single sequence: "
                            f"request {req.request_id} needs a block and no "
                            "victim remains")
                    self._preempt(req, decision, scheduled)
                    break
                self.kv.append_token(req.request_id, toks[k])
                k += 1
            if req in scheduled and k < n:
                # mid-chunk truncation: a prefill chunk keeps its first k
                # tokens; a speculative decode keeps its mandatory feed
                # token plus the first k - 1 drafts
                decision.num_scheduled[req.request_id] = k
                drafts = decision.drafts.pop(req.request_id, None)
                if drafts is not None and k > 1:
                    decision.drafts[req.request_id] = drafts[:k - 1]

        decision.scheduled = scheduled
        for r in scheduled:
            n = decision.num_scheduled[r.request_id]
            if r.is_decode:
                decision.n_decode += 1
                decision.n_decode_tokens += n
                decision.n_draft_tokens += len(
                    decision.drafts.get(r.request_id, ()))
            else:
                decision.n_prefill += 1
                decision.n_prefill_tokens += n
        return decision

    # ------------------------------------------------------------------
    def finish(self, req: Request) -> None:
        """Retire a completed request: free its KV blocks and its lane."""
        req.state = RequestState.FINISHED
        req.done = True
        self.kv.free(req.request_id)
        self.lanes[req.lane] = None
        req.lane = None
        self.running.remove(req)

    def abort(self, req: Request) -> None:
        """Cancellation: detach ``req`` from the scheduler — its lane and
        the running list, or the waiting queue — WITHOUT touching its KV.
        The engine owns the KV teardown
        (:meth:`~repro_torch.serving.blocks.KVCacheManager.release_seq` /
        ``release_chain``), which must run after this so the freed lane
        can never be re-filled while the sequence still holds blocks.
        Only legal between steps, like every scheduler mutation."""
        if req.state is RequestState.RUNNING:
            self.lanes[req.lane] = None
            req.lane = None
            self.running.remove(req)
        else:
            try:
                self.waiting.remove(req)
            except ValueError:
                pass
        if self._blocked_state is not None and self._blocked_state[0] is req:
            self._blocked_state = None
        req.state = RequestState.FINISHED
        req.done = True
        req.cancelled = True
        self.total_cancelled += 1
