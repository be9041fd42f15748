"""Globus-transfer-like managed WAN transfer service.

Implements the paper's transfer cost model (§4.1):

    T = x / v + S        (x bytes, v effective rate, S startup cost)

with the Fig.-3 concurrency-dependent effective rate, per-task RTT-bound
control-channel overhead, optional fault injection with automatic retry
(Globus "fault recovery"), and checksum verification time.  Transfers are
charged to the :class:`SimClock`; payloads themselves move by reference
(the in-process data store hands the object to the destination).

The port's copy of ``repro/core/transfer.py``, unchanged but for its imports.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Any, Dict, List, Optional

from repro_torch.core.facility import Topology
from repro_torch.core.simclock import SimClock


@dataclasses.dataclass
class FileRef:
    """A named payload in a facility's data store."""

    name: str
    nbytes: int
    payload: Any = None


@dataclasses.dataclass
class TransferRecord:
    """Accounting for one completed transfer task.

    ``duration`` is the modeled seconds charged to the clock (including
    retry re-sends); ``rate`` the achieved bytes/s over that duration;
    ``n_files`` the logical file count the concurrency model priced.
    """

    task_id: str
    src: str
    dst: str
    nbytes: int
    n_files: int
    duration: float
    retries: int
    rate: float


class DataStore:
    """Per-facility named object store (stands in for the shared FS)."""

    def __init__(self) -> None:
        """Start with no facilities; they appear on first ``put``."""
        self._stores: Dict[str, Dict[str, FileRef]] = {}

    def put(self, facility: str, ref: FileRef) -> None:
        """Store ``ref`` under its name at ``facility`` (overwrites)."""
        self._stores.setdefault(facility, {})[ref.name] = ref

    def get(self, facility: str, name: str) -> FileRef:
        """Look up a named ref; KeyError when absent."""
        return self._stores[facility][name]

    def exists(self, facility: str, name: str) -> bool:
        """True when ``name`` is stored at ``facility``."""
        return name in self._stores.get(facility, {})


class TransferService:
    """Executes transfer tasks against the topology's cost model.

    Each :meth:`submit` resolves the source refs, prices the move with
    :meth:`duration_model`, charges the result to the shared
    :class:`SimClock`, and hands the payload refs to the destination's
    store.  Optional fault injection replays the Globus fault-recovery
    behaviour: a fault loses a random fraction of the task and the
    remainder is retried (up to 3 times), inflating the charged duration.
    """

    def __init__(self, topo: Topology, clock: SimClock, store: DataStore, *,
                 fault_rate: float = 0.0, seed: int = 0,
                 default_concurrency: int = 8) -> None:
        """Wire the service to a topology, clock and store.

        ``fault_rate`` is the per-attempt probability of a mid-transfer
        fault (deterministic under ``seed``); ``default_concurrency`` the
        stream count used when a submit does not specify one.
        """
        self.topo = topo
        self.clock = clock
        self.store = store
        self.fault_rate = fault_rate
        self.rng = random.Random(seed)
        self.default_concurrency = default_concurrency
        self.records: List[TransferRecord] = []
        self._task_counter = 0

    # ------------------------------------------------------------------
    def duration_model(self, src: str, dst: str, nbytes: int, n_files: int,
                       concurrency: Optional[int] = None) -> float:
        """The paper's linear model T = x/v + S (S scales with #files).

        ``v`` is the link's Fig.-3 concurrency-dependent effective rate for
        ``min(concurrency, n_files)`` parallel streams; the startup term
        pays ``per_file_startup`` once per batch of ``concurrency`` files,
        plus a 2*RTT control-channel round trip per task.
        """
        link = self.topo.link(src, dst)
        conc = concurrency or self.default_concurrency
        v = link.effective_rate(min(conc, n_files))
        startup = link.per_file_startup * ((n_files + conc - 1) // conc)
        control = 2 * link.rtt            # task submit + completion ack
        return nbytes / v + startup + control

    # ------------------------------------------------------------------
    def submit(self, src: str, dst: str, names: List[str], *,
               concurrency: Optional[int] = None,
               n_files: Optional[int] = None,
               label: str = "") -> TransferRecord:
        """Synchronously execute a transfer task (flows await them anyway).

        Moves the named refs from ``src``'s store to ``dst``'s and charges
        the modeled duration to the clock.  ``n_files`` overrides the
        logical file count used by the concurrency model — a single stored
        object may pack many wire-level files (e.g. a serialized KV-block
        shipment), and the override prices it as the multi-stream transfer
        it stands for.  Defaults to ``len(names)``.
        """
        refs = [self.store.get(src, n) for n in names]
        nbytes = sum(r.nbytes for r in refs)
        logical = n_files if n_files is not None else len(refs)
        logical = max(1, logical)
        base = self.duration_model(src, dst, nbytes, logical, concurrency)

        retries = 0
        total = 0.0
        while self.rng.random() < self.fault_rate and retries < 3:
            # fault mid-transfer: lose a random fraction, retry remainder
            frac = self.rng.uniform(0.1, 0.9)
            total += base * frac
            retries += 1
        total += base

        self._task_counter += 1
        task_id = f"xfer-{self._task_counter:05d}"
        self.clock.advance(total, label or f"{task_id} {src}->{dst}", "sim")
        for r in refs:
            self.store.put(dst, r)
        rec = TransferRecord(task_id, src, dst, nbytes, logical, total,
                             retries, nbytes / max(total, 1e-9))
        self.records.append(rec)
        return rec

    # ------------------------------------------------------------------
    def throughput_curve(self, src: str, dst: str, nbytes: int,
                         concurrencies: List[int]) -> Dict[int, float]:
        """Fig.-3 benchmark helper: achieved rate vs concurrency."""
        out = {}
        for c in concurrencies:
            d = self.duration_model(src, dst, nbytes, n_files=max(c, 1),
                                    concurrency=c)
            out[c] = nbytes / d
        return out
