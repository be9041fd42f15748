"""Hybrid simulation clock.

The paper's evaluation metric is *end-to-end turnaround time* across a
geographically distributed workflow.  On one host the compute steps run
for real (measured wall time) while the WAN/service costs are simulated
(the paper's own linear transfer model and measured service overheads).
``SimClock`` fuses the two:

  * ``advance(dt)``      — add simulated seconds (transfer, queueing, RTT);
  * ``measure()``        — context manager measuring real wall time of a
                           compute step and adding it to the clock;
  * ``charge(dt)``       — add *modeled* compute seconds (e.g. DCAI training
                           time derived from a performance model) without
                           running anything for that long.

Every addition is tagged so turnaround decomposes into real compute /
modeled compute / simulated WAN+service seconds.

The port's copy of ``repro/core/simclock.py``.  CUDA work is queued
asynchronously, so ``measure`` synchronizes the current CUDA device (once
CUDA is initialized) before it reads the clock at entry and at exit: a
step is charged the time its kernels ran, not the time they took to
launch.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Iterator, List, Tuple

import torch


def device_sync() -> None:
    """Wait for the current CUDA device's queued work, when CUDA is in
    use (a no-op on the CPU and before CUDA's first use)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@dataclasses.dataclass
class ClockEntry:
    kind: str        # "real" | "modeled" | "sim"
    label: str
    seconds: float
    at: float        # sim timestamp when the entry started


class SimClock:
    """Virtual clock fusing real, modeled, and simulated seconds."""

    def __init__(self) -> None:
        self._now = 0.0
        self.log: List[ClockEntry] = []
        # perf_counter stamps of open measure() blocks (outermost first):
        # while one is open, `now` runs live so latency marks stamped
        # mid-step (t_first_token) land inside the step, not at its start
        self._live: List[float] = []

    @property
    def now(self) -> float:
        """Current sim time; advances live inside an open measure()."""
        if self._live:
            return self._now + (time.perf_counter() - self._live[0])
        return self._now

    def advance(self, seconds: float, label: str = "", kind: str = "sim"
                ) -> None:
        assert seconds >= 0, (label, seconds)
        self.log.append(ClockEntry(kind, label, seconds, self._now))
        self._now += seconds

    def charge(self, seconds: float, label: str = "") -> None:
        self.advance(seconds, label, kind="modeled")

    @contextlib.contextmanager
    def measure(self, label: str = "") -> Iterator[None]:
        """Measure a real compute step: wall time accrues to the clock
        (live through ``now`` while the block is open, committed to
        ``_now`` when the outermost block exits).  The card's queue is
        drained before each reading."""
        device_sync()
        t0 = time.perf_counter()
        start = self.now
        self._live.append(t0)
        try:
            yield
        finally:
            device_sync()
            self._live.pop()
            dt = time.perf_counter() - t0
            self.log.append(ClockEntry("real", label, dt, start))
            if not self._live:
                self._now += dt

    # ------------------------------------------------------------------
    def breakdown(self) -> Dict[str, float]:
        out: Dict[str, float] = {"real": 0.0, "modeled": 0.0, "sim": 0.0}
        for e in self.log:
            out[e.kind] += e.seconds
        out["total"] = self._now
        return out

    def timeline(self) -> List[Tuple[float, str, str, float]]:
        return [(e.at, e.kind, e.label, e.seconds) for e in self.log]
