"""Globus-Flows-like declarative workflow engine.

A *Flow* is a declaratively defined ordering of *Action Providers* with
condition handling (paper §3).  Flows are deployed once (getting a flow id)
and run many times with different inputs — "similar as running a function
with different arguments" (paper appendix §1.2).

Definition format (a plain dict, like the Automate SDK):

    {
      "StartAt": "TransferData",
      "States": {
        "TransferData": {
          "Provider": "transfer",
          "Parameters": {"src": "$.input.src", "dst": "$.input.dc",
                          "names": "$.input.dataset"},
          "Next": "Train",
          "Retries": 2,
          "OnFailure": "NotifyUser"
        },
        "Train": {...},
        ...
        "Done": {"End": true, ...}
      }
    }

``$.``-prefixed strings are JSONPath-style references resolved against
``{"input": <run input>, "results": {<state>: <action result>}}``; lists and
nested dicts are resolved recursively.  Each action execution is timed on the
shared :class:`SimClock` and recorded in the run log — the log is exactly the
per-step breakdown reported in the paper's Table 1.

The port's copy of ``repro/core/flows.py``, unchanged but for its imports.
"""
from __future__ import annotations

import dataclasses
import uuid
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.auth import AuthError, AuthService, SCOPE_FLOWS, Token
from repro_torch.core.simclock import SimClock


class ActionFailure(Exception):
    """Raised by providers to signal a (possibly retryable) action failure."""


class FlowError(Exception):
    pass


# ---------------------------------------------------------------------------
# Action providers
# ---------------------------------------------------------------------------
class ActionProvider:
    """An HTTP-accessible service acting as a single step in a process."""

    name: str = "base"
    required_scope: str = SCOPE_FLOWS
    #: service-side latency per invocation (HTTP + auth round trips)
    invocation_overhead: float = 0.2

    def run(self, params: Dict[str, Any], ctx: "RunContext") -> Any:
        raise NotImplementedError


@dataclasses.dataclass
class RunContext:
    clock: SimClock
    token: Token
    services: Dict[str, Any]


# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ActionExecution:
    state: str
    provider: str
    started_at: float
    duration: float
    status: str                 # "SUCCEEDED" | "FAILED"
    attempts: int
    result: Any = None
    error: str = ""


@dataclasses.dataclass
class FlowRun:
    run_id: str
    flow_id: str
    status: str
    log: List[ActionExecution]
    output: Dict[str, Any]
    turnaround: float

    def step_seconds(self) -> Dict[str, float]:
        return {e.state: e.duration for e in self.log}


# ---------------------------------------------------------------------------
def _resolve(value: Any, scope: Dict[str, Any]) -> Any:
    if isinstance(value, str) and value.startswith("$."):
        node: Any = scope
        for part in value[2:].split("."):
            if isinstance(node, dict):
                node = node[part]
            else:
                node = getattr(node, part)
        return node
    if isinstance(value, dict):
        return {k: _resolve(v, scope) for k, v in value.items()}
    if isinstance(value, list):
        return [_resolve(v, scope) for v in value]
    return value


class FlowsService:
    def __init__(self, clock: SimClock, auth: AuthService,
                 providers: Dict[str, ActionProvider],
                 services: Optional[Dict[str, Any]] = None) -> None:
        self.clock = clock
        self.auth = auth
        self.providers = providers
        self.services = services or {}
        self._flows: Dict[str, Dict] = {}

    # ------------------------------------------------------------------
    def deploy(self, definition: Dict) -> str:
        if "StartAt" not in definition or "States" not in definition:
            raise FlowError("definition needs StartAt and States")
        start = definition["StartAt"]
        states = definition["States"]
        if start not in states:
            raise FlowError(f"StartAt {start!r} not in States")
        for name, st in states.items():
            if "Provider" in st and st["Provider"] not in self.providers:
                raise FlowError(f"unknown provider {st['Provider']!r}"
                                f" in state {name!r}")
            if st.get("End"):
                continue
            nxt = st.get("Next")
            if nxt is not None and nxt not in states:
                raise FlowError(f"state {name!r} Next -> unknown {nxt!r}")
            fb = st.get("OnFailure")
            if fb is not None and fb not in states:
                raise FlowError(f"state {name!r} OnFailure -> unknown {fb!r}")
        fid = f"flow-{uuid.uuid4().hex[:12]}"
        self._flows[fid] = definition
        return fid

    # ------------------------------------------------------------------
    def run(self, flow_id: str, flow_input: Dict[str, Any],
            token: Token) -> FlowRun:
        self.auth.validate(token)
        token.require(SCOPE_FLOWS)
        definition = self._flows[flow_id]
        states = definition["States"]
        scope: Dict[str, Any] = {"input": flow_input, "results": {}}
        ctx = RunContext(self.clock, token, self.services)

        log: List[ActionExecution] = []
        t_start = self.clock.now
        current: Optional[str] = definition["StartAt"]
        status = "SUCCEEDED"
        guard = 0

        while current is not None:
            guard += 1
            if guard > 1000:
                raise FlowError("flow exceeded 1000 state transitions")
            st = states[current]
            if st.get("End") and "Provider" not in st:
                break
            provider = self.providers[st["Provider"]]
            retries = int(st.get("Retries", 0))
            attempts = 0
            started = self.clock.now
            result, err = None, ""
            while True:
                attempts += 1
                try:
                    self.auth.validate(token)
                    token.require(provider.required_scope)
                    self.clock.advance(provider.invocation_overhead,
                                       f"{current} [provider http]", "sim")
                    params = _resolve(st.get("Parameters", {}), scope)
                    result = provider.run(params, ctx)
                    ok = True
                    break
                except (ActionFailure, AuthError, KeyError) as e:  # noqa: PERF203
                    err = f"{type(e).__name__}: {e}"
                    ok = False
                    if attempts > retries:
                        break
            exec_rec = ActionExecution(
                state=current, provider=st["Provider"], started_at=started,
                duration=self.clock.now - started,
                status="SUCCEEDED" if ok else "FAILED",
                attempts=attempts, result=result, error=err)
            log.append(exec_rec)
            scope["results"][current] = result

            if ok:
                current = st.get("Next")
                if current is None and not st.get("End", False):
                    break
            else:
                fb = st.get("OnFailure")
                if fb is None:
                    status = "FAILED"
                    break
                current = fb

        return FlowRun(
            run_id=f"run-{uuid.uuid4().hex[:12]}",
            flow_id=flow_id,
            status=status,
            log=log,
            output=scope["results"],
            turnaround=self.clock.now - t_start,
        )
