"""Spans and counters inside the paged engine's step.

Each :class:`~repro_torch.serving.engine.PagedDecodeEngine` owns one
:class:`Tracer` (``engine.trace``).  A span is a named stretch of host
time (``with tracer.span("schedule"): ...``); spans nest, and each keeps
its **self** time: a child's time is taken out of its parent's.  So the
children of ``step`` tile it: their self times plus ``step``'s own
remainder add up to the step's wall time.

Two things are kept:

  * **counters**, always: per span name its summed self seconds and its
    call count, ``span_s.<name>`` and ``span_n.<name>`` in ``stats()``
    (two clock reads and a few adds per span);
  * **the span log**, only while a ``torch.profiler`` session records:
    ``(name, start_ns, end_ns, step index)`` per closed span, at most
    :attr:`Tracer.cap` entries (the rest counted as dropped), stamped on
    the clock of the profiler's own events (:func:`stamp`), so that it
    lines up with the device trace.  ``stats()`` returns it under
    ``trace_spans`` while it is on.

The program opens no ``record_function`` or NVTX range: a range's device
shadow would read as device work in a trace.  The spans reach a reader
through ``stats()`` alone.

While the log is on and the engine runs on a card, an MoE layer marks the
boundaries of its stages with CUDA events (:class:`MoEStages`): the
route (softmax, top-k, one-hot, capacity cumsum) and the dispatch (slot
one-hot, dispatch and combine contractions; the experts' GEMMs left
out).  A stage's time is the elapsed time between its events on the
stream, launch gaps included: what a launch-bound layer costs.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

# the span names, as ``stats()`` spells them; children of ``step`` in the
# order a step runs them (``draft`` and ``swap_out`` nest in ``schedule``,
# ``on_token`` in ``verify``)
SPANS = ("step", "schedule", "draft", "swap_out", "swap_in", "cow",
         "prepare", "launch", "readback", "verify", "on_token")
MOE_STAGES = ("route", "dispatch")


def stamp() -> int:
    """Now, in nanoseconds since the Unix epoch: the clock on which
    ``torch.profiler`` (kineto) stamps its events' ``start_ns()``."""
    return time.time_ns()


def profiling() -> bool:
    """True while a ``torch.profiler`` session records."""
    return torch.autograd.profiler._is_profiler_enabled


class _Span:
    """The context manager of one span name; ``ns`` is the wall time of
    its last closed span."""

    __slots__ = ("tracer", "name", "ns")

    def __init__(self, tracer: "Tracer", name: str) -> None:
        self.tracer = tracer
        self.name = name
        self.ns = 0

    def __enter__(self) -> "_Span":
        self.tracer._stack.append([self.name, stamp(), 0])
        return self

    def __exit__(self, *exc) -> bool:
        self.ns = self.tracer._close()
        return False


class MoEStages:
    """CUDA events at the MoE layers' stage boundaries within one step.

    ``mark(device, stage)`` records an event on the device's current
    stream; the stretch up to the next mark belongs to ``stage`` (None:
    not timed, e.g. the experts' GEMMs, or the gap to the next layer).
    :meth:`collect` adds each timed stretch's elapsed time once the step's
    readback has passed its events, and counts a traced step."""

    def __init__(self) -> None:
        self.marks: List[Tuple[Optional[str], "torch.cuda.Event",
                               torch.device]] = []
        self._free: Dict[torch.device, List["torch.cuda.Event"]] = {}
        self.ms = dict.fromkeys(MOE_STAGES, 0.0)
        self.steps = 0

    def mark(self, device: torch.device, stage: Optional[str]) -> None:
        free = self._free.setdefault(device, [])
        ev = free.pop() if free else torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(device))
        self.marks.append((stage, ev, device))

    def collect(self) -> None:
        if not self.marks:
            return
        for (stage, a, _), (_, b, _) in zip(self.marks, self.marks[1:]):
            if stage is not None:
                if not b.query():           # another card's stream
                    b.synchronize()
                self.ms[stage] += a.elapsed_time(b)
        for _, ev, dev in self.marks:
            self._free[dev].append(ev)
        self.marks = []
        self.steps += 1


class Tracer:
    """Self-time counters of the step's spans, and their log while a
    profiler records (module docstring)."""

    cap = 1 << 18                   # log entries kept per profiler session

    def __init__(self) -> None:
        self.self_ns = dict.fromkeys(SPANS, 0)
        self.calls = dict.fromkeys(SPANS, 0)
        self._spans = {n: _Span(self, n) for n in SPANS}
        self._stack: List[list] = []        # [name, start_ns, children_ns]
        self.logging = False
        self.log: List[Tuple[str, int, int, int]] = []
        self.dropped = 0
        self.step_index = 0
        self.moe = MoEStages()

    def span(self, name: str) -> _Span:
        """``with tracer.span(name):`` times the block as span ``name``."""
        return self._spans[name]

    def begin_step(self, index: int) -> None:
        """Read the profiler's state once a step: a session that starts
        begins a fresh log, one that ended frees it."""
        on = profiling()
        if on != self.logging:
            self.log, self.dropped = [], 0
            self.logging = on
        self.step_index = index

    def _close(self) -> int:
        t1 = stamp()
        name, t0, children = self._stack.pop()
        ns = t1 - t0
        self.self_ns[name] += ns - children
        self.calls[name] += 1
        if self._stack:
            self._stack[-1][2] += ns
        if self.logging:
            if len(self.log) < self.cap:
                self.log.append((name, t0, t1, self.step_index))
            else:
                self.dropped += 1
        return ns

    def stats(self) -> Dict[str, object]:
        """``span_s.<name>`` (self seconds), ``span_n.<name>`` (calls),
        ``moe_ms.<stage>`` and ``moe_traced_steps``; while the log is on,
        a copy of it under ``trace_spans`` and ``trace_spans_dropped``."""
        out: Dict[str, object] = {}
        for n in SPANS:
            out[f"span_s.{n}"] = self.self_ns[n] * 1e-9
            out[f"span_n.{n}"] = self.calls[n]
        for s in MOE_STAGES:
            out[f"moe_ms.{s}"] = self.moe.ms[s]
        out["moe_traced_steps"] = self.moe.steps
        if self.logging:
            out["trace_spans"] = list(self.log)
            out["trace_spans_dropped"] = self.dropped
        return out


class TimedProposer:
    """A draft proposer whose every ``propose`` call is the tracer's
    ``draft`` span."""

    def __init__(self, inner, tracer: Tracer) -> None:
        self.inner = inner
        self.tracer = tracer

    def propose(self, tokens: Sequence[int], k: int) -> List[int]:
        with self.tracer.span("draft"):
            return self.inner.propose(tokens, k)
