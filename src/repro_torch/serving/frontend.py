"""Async streaming frontend and open-loop serving harness.

The counterpart of ``repro/serving/frontend.py``; two entry points on top
of the decode engines (``engine.py``):

  * :class:`AsyncEngine` — the online surface.  A dedicated **step
    thread** owns every engine touch (``submit`` / ``cancel`` /
    ``step`` / ``take_finished``); callers talk to it through a
    lock-protected mailbox, so the thread-unsafe engine internals are
    serialized by construction.  Per-token delivery rides the engine's
    ``on_token`` streaming hook (fired inside ``step()`` on the step
    thread) into per-request sinks; :meth:`AsyncEngine.stream` adapts a
    sink to an ``async`` generator, and a consumer that disconnects
    (``asyncio.CancelledError``) cancels its request mid-flight — which
    frees the sequence's KV blocks, prefix-cache residue, queued
    swap-ins, and host-tier payloads (``PagedDecodeEngine.cancel``).

  * :func:`run_open_loop` — the paper's evaluation shape: requests
    arrive on a Poisson-style schedule (arrival times are the caller's,
    pre-seeded), the engine steps whenever work exists, and a shared
    :class:`~repro_torch.core.simclock.SimClock` stamps every latency
    mark.  Real step wall time accrues to the virtual clock via
    ``clock.measure`` (which drains the card's queue before each
    reading, so a step is charged the time its kernels ran); idle gaps
    between arrivals are simulated with ``clock.advance`` — so
    goodput-vs-offered-load curves are deterministic given the arrival
    schedule, yet use measured compute.

Cancellation invariants (the reference's test walls pin these):

  * a cancel is only ever applied **between** engine steps — the step
    thread drains the cancel mailbox before calling ``step()``;
  * cancelling an unknown/finished id is a no-op returning False;
  * after cancelling everything and draining, the block pool and the
    host swap tier are empty (no leaked refcounts, no orphaned
    payloads, no stale queued swap-ins).

Where PyTorch on CUDA differs from the reference's JAX, the step thread
does three things itself:

  * **grad mode is thread-local**, so the step thread enters
    ``torch.no_grad()``.  Not ``torch.inference_mode()``: pools and swap
    buffers allocated on the step thread would become inference tensors,
    and the first in-place pool write after :meth:`AsyncEngine.stop`,
    from another thread, would raise;
  * **the CUDA current device is per host thread**, so the step thread
    makes the engine's device current before its first step (the
    kernels launch on ``torch.cuda.current_stream`` of their tensors'
    device, in the thread's own context);
  * **a step that raises ends the thread**, as in the reference: the
    exception is reported by ``threading``'s hook and nothing resolves
    any more, so every wait on a ticket must carry a timeout
    (:meth:`AsyncEngine.result` takes one) to turn a fault on the card
    into an error instead of a hang.
"""
from __future__ import annotations

import asyncio
import dataclasses
import threading
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.simclock import SimClock
from repro_torch.serving.scheduler import Request


# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Ticket:
    """Handle for one in-flight :class:`AsyncEngine` request.

    ``done`` is set when the request finishes, is cancelled, or is shed
    by SLO admission; ``result`` then holds the engine's
    :class:`~repro_torch.serving.scheduler.Request` record.  ``sink`` (if
    set) receives ``(token, finished)`` pairs from the step thread as
    they are emitted; after a terminal event with no final token (cancel
    / shed) it receives ``(None, True)``.
    """

    prompt: np.ndarray
    max_new_tokens: int
    priority: int = 0
    sink: Optional[Callable[[Optional[int], bool], None]] = None
    request_id: Optional[int] = None
    result: Optional[Request] = None
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    _terminal_sent: bool = False

    def _push(self, tok: int, finished: bool) -> None:
        if finished:
            self._terminal_sent = True
        if self.sink is not None:
            self.sink(tok, finished)

    def _resolve(self, result: Request) -> None:
        self.result = result
        if not self._terminal_sent:
            self._terminal_sent = True
            if self.sink is not None:
                self.sink(None, True)
        self.done.set()


class AsyncEngine:
    """Asyncio-friendly streaming frontend over one decode engine.

    All engine access happens on the internal step thread; ``submit``
    and ``cancel`` only enqueue intents into a mailbox and wake it.  Use
    as a context manager::

        with AsyncEngine(engine) as fe:
            ticket = fe.submit(prompt, max_new_tokens=32)
            req = fe.result(ticket, timeout=60)   # blocking
            # or, inside an event loop:
            async for tok in fe.stream(prompt, 32):
                ...

    A consumer cancelling :meth:`stream` (client disconnect) aborts the
    request on the engine, freeing its KV immediately rather than
    decoding tokens nobody will read.
    """

    def __init__(self, engine: Any) -> None:
        """Wrap ``engine`` (paged or slot — anything with the
        ``submit / cancel / step / has_work / take_finished / on_token``
        surface; its ``device``, when it has one, is made current on the
        step thread).  The engine must not be touched by other threads
        while the frontend is running."""
        self.engine = engine
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._pending: deque = deque()       # tickets awaiting submit
        self._cancels: deque = deque()       # tickets awaiting cancel
        self._by_rid: Dict[int, Ticket] = {}
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self.steps = 0

    # ------------------------------------------------------------------
    def start(self) -> "AsyncEngine":
        """Install the streaming hook and launch the step thread."""
        if self._running:
            return self
        self.engine.on_token = self._dispatch
        self._running = True
        self._thread = threading.Thread(
            target=self._loop, name="async-engine-step", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the step thread (drains nothing: pending work stays on
        the engine) and detach the streaming hook."""
        with self._wake:
            if not self._running:
                return
            self._running = False
            self._wake.notify()
        assert self._thread is not None
        self._thread.join()
        self._thread = None
        self.engine.on_token = None

    def __enter__(self) -> "AsyncEngine":
        """Context-manager entry: :meth:`start`."""
        return self.start()

    def __exit__(self, *exc) -> None:
        """Context-manager exit: :meth:`stop`."""
        self.stop()

    # ------------------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new_tokens: int,
               priority: int = 0,
               sink: Optional[Callable[[Optional[int], bool], None]] = None,
               ) -> Ticket:
        """Enqueue a request; returns its :class:`Ticket` immediately.

        ``sink(token, finished)`` — if given — is called from the step
        thread per emitted token (keep it cheap and thread-safe; for
        asyncio consumers use :meth:`stream` instead, which wraps a sink
        in ``loop.call_soon_threadsafe``).
        """
        ticket = Ticket(np.asarray(prompt, np.int32), max_new_tokens,
                        priority=priority, sink=sink)
        with self._wake:
            if not self._running:
                raise RuntimeError("AsyncEngine is not running "
                                   "(use `with AsyncEngine(engine):`)")
            self._pending.append(ticket)
            self._wake.notify()
        return ticket

    def cancel(self, ticket: Ticket) -> None:
        """Request cancellation of ``ticket``.  Applied by the step
        thread between engine steps; no-op if already finished."""
        with self._wake:
            if ticket.done.is_set():
                return
            if ticket.request_id is None and ticket in self._pending:
                # never reached the engine: resolve it right here
                self._pending.remove(ticket)
                req = Request(-1, ticket.prompt, ticket.max_new_tokens,
                              priority=ticket.priority)
                req.done = True
                req.cancelled = True
                ticket._resolve(req)
                return
            self._cancels.append(ticket)
            self._wake.notify()

    def result(self, ticket: Ticket,
               timeout: Optional[float] = None) -> Request:
        """Block until ``ticket`` resolves; returns the engine's request
        record (check ``.cancelled`` / ``.shed``).  Raises
        ``TimeoutError`` after ``timeout`` seconds."""
        if not ticket.done.wait(timeout):
            raise TimeoutError("request did not resolve in time")
        assert ticket.result is not None
        return ticket.result

    async def stream(self, prompt: np.ndarray, max_new_tokens: int,
                     priority: int = 0):
        """Async generator yielding tokens as the engine emits them.

        Cancelling the consuming task (client disconnect) aborts the
        request on the engine — the mid-flight KV teardown path.
        """
        loop = asyncio.get_running_loop()
        q: asyncio.Queue = asyncio.Queue()
        ticket = self.submit(
            prompt, max_new_tokens, priority=priority,
            sink=lambda tok, fin: loop.call_soon_threadsafe(
                q.put_nowait, (tok, fin)))
        try:
            while True:
                tok, fin = await q.get()
                if tok is not None:
                    yield tok
                if fin:
                    break
        finally:
            # normal exhaustion: done already set, cancel() is a no-op
            self.cancel(ticket)

    # ------------------------------------------------------------------
    def _dispatch(self, rid: int, tok: int, finished: bool) -> None:
        # step-thread context (fired inside engine.step())
        ticket = self._by_rid.get(rid)
        if ticket is not None:
            ticket._push(tok, finished)

    def _loop(self) -> None:
        device = getattr(self.engine, "device", None)
        if device is not None and device.type == "cuda":
            torch.cuda.set_device(device)
        with torch.no_grad():
            self._serve()

    def _serve(self) -> None:
        while True:
            with self._wake:
                while (self._running and not self._pending
                       and not self._cancels
                       and not self.engine.has_work()):
                    self._wake.wait()
                if not self._running:
                    return
                pending = list(self._pending)
                self._pending.clear()
                cancels = list(self._cancels)
                self._cancels.clear()
            # engine work happens OUTSIDE the lock: submit/cancel only
            # touch the mailbox, so they never block on a running step
            for t in pending:
                t.request_id = self.engine.submit(
                    t.prompt, t.max_new_tokens, priority=t.priority)
                self._by_rid[t.request_id] = t
            for t in cancels:
                if t.request_id is not None and not t.done.is_set():
                    self.engine.cancel(t.request_id)
            if self.engine.has_work():
                self.engine.step()
                self.steps += 1
            for r in self.engine.take_finished():
                ticket = self._by_rid.pop(r.request_id, None)
                if ticket is not None:
                    ticket._resolve(r)


# ---------------------------------------------------------------------------
@dataclasses.dataclass
class OpenRequest:
    """One request of an open-loop arrival schedule.

    ``t_arrival`` is in virtual seconds; ``cancel_after`` (if set)
    aborts the request that many virtual seconds after arrival — the
    harness's client-disconnect model.
    """

    prompt: np.ndarray
    max_new_tokens: int
    t_arrival: float
    priority: int = 0
    cancel_after: Optional[float] = None


def run_open_loop(engine: Any, requests: Sequence[OpenRequest], *,
                  clock: Optional[SimClock] = None,
                  ttft_target: float = 0.0, tpot_target: float = 0.0,
                  max_steps: int = 100_000) -> Dict[str, Any]:
    """Drive ``engine`` through an open-loop arrival schedule on a
    virtual clock; returns per-request records and goodput aggregates.

    Requests are submitted when the clock reaches their ``t_arrival``
    (idle gaps are simulated with ``clock.advance``; compute accrues
    real measured step time via ``clock.measure``), cancels fire at
    ``t_arrival + cancel_after``, and a request **meets SLO** when it
    completes (not cancelled/shed) with TTFT and TPOT within the given
    targets (0 = don't check).  ``goodput_ratio`` is met-SLO completions
    over offered requests, excluding intentional harness cancels.
    """
    clock = clock or SimClock()
    engine.set_clock(clock)
    if ttft_target > 0 or tpot_target > 0:
        scheds = ([e.scheduler for e in engine.engines]
                  if hasattr(engine, "engines")
                  else [engine.scheduler])
        for s in scheds:
            s.cfg.ttft_target = ttft_target
            s.cfg.tpot_target = tpot_target

    arrivals = sorted(requests, key=lambda r: r.t_arrival)
    by_rid: Dict[int, OpenRequest] = {}
    cancels: List[tuple] = []       # (t_cancel, rid) — unordered heap-lite
    next_arrival = 0
    finished: List[Request] = []
    steps = 0
    while True:
        now = clock.now
        while (next_arrival < len(arrivals)
               and arrivals[next_arrival].t_arrival <= now):
            o = arrivals[next_arrival]
            rid = engine.submit(o.prompt, o.max_new_tokens,
                                priority=o.priority)
            by_rid[rid] = o
            if o.cancel_after is not None:
                cancels.append((o.t_arrival + o.cancel_after, rid))
            next_arrival += 1
        due = [(t, rid) for (t, rid) in cancels if t <= now]
        if due:
            cancels = [(t, rid) for (t, rid) in cancels if t > now]
            for _, rid in sorted(due):
                engine.cancel(rid)
        if engine.has_work():
            with clock.measure("step"):
                engine.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(
                    f"open loop exceeded {max_steps} steps")
        else:
            horizon = [arrivals[next_arrival].t_arrival] \
                if next_arrival < len(arrivals) else []
            horizon += [t for (t, _) in cancels]
            if not horizon:
                finished.extend(engine.take_finished())
                break
            clock.advance(max(min(horizon) - clock.now, 0.0),
                          "idle (awaiting arrivals)")
        finished.extend(engine.take_finished())

    records = []
    met = completed = n_cancelled = n_shed = 0
    for r in finished:
        status = ("cancelled" if r.cancelled
                  else "shed" if r.shed else "ok")
        ttft = (r.t_first_token - r.t_submit
                if r.t_first_token > 0.0 else None)
        tpot = ((r.t_done - r.t_first_token)
                / max(len(r.generated) - 1, 1)
                if status == "ok" and r.t_first_token > 0.0 else None)
        ok = (status == "ok"
              and (ttft_target <= 0
                   or (ttft is not None and ttft <= ttft_target))
              and (tpot_target <= 0
                   or (tpot is not None and tpot <= tpot_target)))
        met += ok
        completed += status == "ok"
        n_cancelled += status == "cancelled"
        n_shed += status == "shed"
        records.append({"request_id": r.request_id, "status": status,
                        "priority": r.priority, "ttft": ttft,
                        "tpot": tpot, "met_slo": bool(ok),
                        "tokens": len(r.generated)})

    offered = len(requests)
    denom = max(offered - n_cancelled, 1)
    ttfts = sorted(x["ttft"] for x in records if x["ttft"] is not None)

    def _pct(p: float) -> Optional[float]:
        if not ttfts:
            return None
        return ttfts[min(int(p * len(ttfts)), len(ttfts) - 1)]

    span = (arrivals[-1].t_arrival - arrivals[0].t_arrival
            if len(arrivals) > 1 else 0.0)
    return {
        "offered": offered,
        "completed": completed,
        "met_slo": met,
        "cancelled": n_cancelled,
        "shed": n_shed,
        "goodput_ratio": met / denom,
        "offered_rps": offered / span if span > 0 else float("inf"),
        "goodput_rps": met / clock.now if clock.now > 0 else 0.0,
        "makespan": clock.now,
        "ttft_p50": _pct(0.50),
        "ttft_p95": _pct(0.95),
        "steps": steps,
        "records": records,
    }
