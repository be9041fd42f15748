"""funcX-like federated function-as-a-service fabric.

Any facility device becomes a function-serving *endpoint*; functions are
registered once (getting a function id) and invoked fire-and-forget against
an endpoint id — exactly the paper's usage pattern (appendix §1.1).

Execution modes per endpoint:
  * ``real``    — run the registered Python function here, measure wall time
                  (used for edge/local steps and for real small-model DCAI
                  training in the examples);
  * ``modeled`` — run the function for its *result* (correctness) but charge
                  the clock a modeled duration: either a caller-supplied
                  estimate, or wall-time scaled by the endpoint's speedup
                  versus this host (used to model DCAI turnaround, clearly
                  tagged "modeled" in the clock log).

Service overheads (submission RTT, scheduler queue wait) are charged per
invocation from the device record, mirroring the paper's observation that
service overhead is a real part of end-to-end turnaround.

The port's copy of ``repro/core/funcx.py``.  A real-mode run is timed
between two synchronizations of the CUDA card (as ``SimClock.measure``
times it), so a function that leaves kernels queued is charged for them;
modeled mode is unchanged.
"""
from __future__ import annotations

import dataclasses
import time
import uuid
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.core.facility import ComputeDevice, Topology
from repro_torch.core.simclock import SimClock, device_sync


@dataclasses.dataclass
class Endpoint:
    endpoint_id: str
    device: ComputeDevice
    mode: str = "real"                    # "real" | "modeled"
    speedup_vs_host: float = 1.0          # used when mode == "modeled"


@dataclasses.dataclass
class TaskResult:
    task_id: str
    endpoint_id: str
    function_id: str
    result: Any
    duration: float          # seconds charged to the clock (compute only)
    overhead: float          # service + queue seconds charged
    mode: str


class FuncXService:
    def __init__(self, topo: Topology, clock: SimClock) -> None:
        self.topo = topo
        self.clock = clock
        self.functions: Dict[str, Callable] = {}
        self.endpoints: Dict[str, Endpoint] = {}
        self._task_counter = 0

    # ------------------------------------------------------------------
    def register_function(self, fn: Callable, name: str = "") -> str:
        fid = f"fn-{name or fn.__name__}-{uuid.uuid4().hex[:8]}"
        self.functions[fid] = fn
        return fid

    def register_endpoint(self, device_name: str, *, mode: str = "real",
                          speedup_vs_host: float = 1.0) -> str:
        dev = self.topo.device(device_name)
        eid = f"ep-{device_name}-{uuid.uuid4().hex[:8]}"
        self.endpoints[eid] = Endpoint(eid, dev, mode, speedup_vs_host)
        return eid

    # ------------------------------------------------------------------
    def run(self, endpoint_id: str, function_id: str, *args,
            modeled_duration: Optional[float] = None,
            label: str = "", **kwargs) -> TaskResult:
        ep = self.endpoints[endpoint_id]
        fn = self.functions[function_id]
        self._task_counter += 1
        task_id = f"task-{self._task_counter:05d}"
        lbl = label or f"{task_id} {function_id}@{ep.device.name}"

        overhead = ep.device.service_overhead + ep.device.queue_wait
        if overhead:
            self.clock.advance(overhead, lbl + " [service]", "sim")

        if ep.mode == "real":
            device_sync()
            t0 = time.perf_counter()
            with self.clock.measure(lbl):
                result = fn(*args, **kwargs)
            duration = time.perf_counter() - t0
        else:
            t0 = time.perf_counter()
            result = fn(*args, **kwargs)
            wall = time.perf_counter() - t0
            duration = (modeled_duration if modeled_duration is not None
                        else wall / max(ep.speedup_vs_host, 1e-9))
            self.clock.charge(duration, lbl + " [modeled]")

        return TaskResult(task_id, endpoint_id, function_id, result,
                          duration, overhead, ep.mode)
