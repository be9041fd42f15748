"""The paper's analytical performance model (§4) — Equations (1)-(3).

Six primitive operations over a datum d:
  C(ollect), S(imulate), A(nalyze, conventional), T(rain), D(eploy),
  E(stimate with the ML surrogate);
locations as subscripts (ex = experiment facility, dc = data center); data
movement  a --d--> b  costed by the transfer service's linear model.

Strategies (per-datum costs in seconds unless noted):
  f_c(N)   Eq.(1): ship data to DC, analyze conventionally, ship results back
  f_ex(N)  Eq.(2): analyze conventionally at the experiment
  f_ml(N)  Eq.(3): ship a fraction p to DC, label it with A, train the
           surrogate T, ship the model back, Estimate the remaining (1-p)N

``crossover`` solves f_c(N) = f_ml(N) for N — the dataset size above which
the ML-surrogate pipeline wins (Fig. 4's crossing point).

The port's copy of ``repro/core/costmodel.py``, unchanged but for its imports.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core.facility import Topology
from repro_torch.core.transfer import TransferService


@dataclasses.dataclass(frozen=True)
class OperationCosts:
    """Per-datum / per-run operation costs (seconds).

    Defaults are the paper's §4.2 BraggNN/HEDM numbers:
      * A: 2000 core-seconds per 800K peaks on a 1024-core cluster
           -> 2.44 us/peak
      * E: 800K peaks in 280 ms batched -> 0.35 us/peak
      * datum: one 11x11 16-bit patch = 242 bytes -> 0.24 us at 1 GB/s
      * result bytes: 8 per datum (two fp32 coordinates)
      * T: 19 s on Cerebras (Table 1)
      * model: 3 MB BraggNN artifact
    """

    analyze_dc: float = 2.44e-6
    analyze_ex: float = 9.77e-6       # 4x fewer cores at the experiment
    estimate_ex: float = 0.35e-6
    collect: float = 0.0
    simulate: float = 0.0
    train: float = 19.0
    deploy: float = 0.5               # load model onto the edge device
    datum_bytes: int = 242
    result_bytes: int = 8
    model_bytes: int = 3_000_000


@dataclasses.dataclass(frozen=True)
class StrategyCost:
    total: float
    breakdown: Dict[str, float]

    def per_datum(self, n: int) -> float:
        return self.total / max(n, 1)


class CostModel:
    def __init__(self, topo: Topology, transfer: TransferService,
                 costs: Optional[OperationCosts] = None,
                 ex: str = "slac", dc: str = "alcf") -> None:
        self.topo = topo
        self.transfer = transfer
        self.costs = costs or OperationCosts()
        self.ex = ex
        self.dc = dc

    # -- helpers ---------------------------------------------------------
    def _move(self, src: str, dst: str, nbytes: int, n_files: int = 1
              ) -> float:
        return self.transfer.duration_model(src, dst, nbytes, n_files)

    # -- Eq. (1): conventional at the data center -------------------------
    def f_conventional_dc(self, n: int) -> StrategyCost:
        c = self.costs
        up = self._move(self.ex, self.dc, n * c.datum_bytes)
        analyze = n * c.analyze_dc
        down = self._move(self.dc, self.ex, n * c.result_bytes)
        return StrategyCost(up + analyze + down, {
            "data_up": up, "analyze": analyze, "results_down": down})

    # -- Eq. (2): conventional at the experiment --------------------------
    def f_conventional_ex(self, n: int) -> StrategyCost:
        analyze = n * self.costs.analyze_ex
        return StrategyCost(analyze, {"analyze": analyze})

    # -- Eq. (3): ML surrogate via remote DCAI ----------------------------
    def f_ml(self, n: int, p: float = 0.1, *,
             train_seconds: Optional[float] = None) -> StrategyCost:
        c = self.costs
        n_sub = int(p * n)
        up = self._move(self.ex, self.dc, n_sub * c.datum_bytes)
        label = n_sub * c.analyze_dc
        train = train_seconds if train_seconds is not None else c.train
        model_down = self._move(self.dc, self.ex, c.model_bytes)
        labels_down = self._move(self.dc, self.ex, n_sub * c.result_bytes)
        estimate = (n - n_sub) * c.estimate_ex
        total = up + label + train + model_down + labels_down + \
            c.deploy + estimate
        return StrategyCost(total, {
            "data_up": up, "label": label, "train": train,
            "model_down": model_down, "labels_down": labels_down,
            "deploy": c.deploy, "estimate": estimate})

    # -- Eq. (3') — paper future-work #3: overlap A (labeling) and T --------
    def f_ml_pipelined(self, n: int, p: float = 0.1, *,
                       train_seconds: Optional[float] = None,
                       n_microbatches: int = 16) -> StrategyCost:
        """Mini-batch training starts before all labels exist: A and T run
        as a software pipeline with ``n_microbatches`` stages; the critical
        path is max(A, T) plus one pipeline-fill stage of the other."""
        c = self.costs
        n_sub = int(p * n)
        up = self._move(self.ex, self.dc, n_sub * c.datum_bytes)
        label = n_sub * c.analyze_dc
        train = train_seconds if train_seconds is not None else c.train
        stage = 1.0 / max(n_microbatches, 1)
        overlapped = max(label, train) + stage * min(label, train)
        model_down = self._move(self.dc, self.ex, c.model_bytes)
        labels_down = self._move(self.dc, self.ex, n_sub * c.result_bytes)
        estimate = (n - n_sub) * c.estimate_ex
        total = up + overlapped + model_down + labels_down + \
            c.deploy + estimate
        return StrategyCost(total, {
            "data_up": up, "label_train_overlapped": overlapped,
            "model_down": model_down, "labels_down": labels_down,
            "deploy": c.deploy, "estimate": estimate})

    # -- crossover (Fig. 4) ------------------------------------------------
    def crossover(self, p: float = 0.1, lo: int = 1, hi: int = 10**10
                  ) -> Optional[int]:
        """Smallest N where f_ml(N) <= f_conventional_dc(N), or None."""
        f = lambda n: (self.f_ml(n, p).total
                       - self.f_conventional_dc(n).total)
        if f(hi) > 0:
            return None
        if f(lo) <= 0:
            return lo
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if f(mid) <= 0:
                hi = mid
            else:
                lo = mid
        return hi

    def advise(self, n: int, p: float = 0.1) -> str:
        """Pre-processing decision (paper: "can be used to decide which
        solution to take before processing")."""
        options = {
            "conventional_dc": self.f_conventional_dc(n).total,
            "conventional_ex": self.f_conventional_ex(n).total,
            "ml_surrogate": self.f_ml(n, p).total,
        }
        return min(options, key=options.get)
