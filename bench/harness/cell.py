"""One run of one cell: set-up, the measured window, the check, the
metrics.

The cell's entry in ``BENCHMARK.json`` names its configuration
(``bench/configs/<config>.json``) and its traffic
(``bench/mixes/<traffic>.json``); its metrics are the files
``bench/metrics/<metric>.py`` named there, and the limits of its check
``bench/limits/<cell>.json``.  Nothing here names a cell.

Set-up: the program's architecture (which must equal the configuration
file), the seeded weights, the engine with the mix's settings and every
other engine setting at its default; one step at each power-of-two
bucket up to the token budget; the mix's shared contexts prefilled; then
the traffic itself for ``warm_s`` seconds.  The window follows, for
``seconds`` seconds; with ``trace`` it runs under ``torch.profiler``.
After it an open loop keeps its schedule going until every request due
in the window has its first token (at most ``DRAIN_S`` seconds), so that
a tail counts each wait in full.  Then the check (``check.py``): with
the limits' ``"method": "sequence"`` the engine is freed first and the
reference runs the sampled requests whole; with ``"replay"`` the cache
the window left is checked against the requests' tokens at the layers
where they alone decide it, then the traffic goes on for a few more
steps, each recomputed by the reference from the cache it ran on,
before the engine is freed.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from bench.harness import check as check_lib
from bench.harness import model_config as mc
from bench.harness import trace as trace_lib
from bench.harness import traffic as traffic_lib
from bench.harness import weights as weights_lib
from bench.harness.drive import Driver

BENCH = Path(__file__).resolve().parent.parent
DRAIN_S = 60.0
REPLAY_STEPS = 24
HOST_RANGES = ("bench.step", "bench.submit")


def cell_entry(bench_json: Dict, workload: str) -> Dict:
    for w in bench_json["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def load_json(path: Path) -> Dict:
    if not path.exists():
        raise FileNotFoundError(f"missing {path}")
    return json.loads(path.read_text())


def metric_reader(name: str, root: Path = BENCH):
    """``read(run)`` of ``bench/metrics/<name>.py``."""
    path = root / "metrics" / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no metric reader {path}")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench_json: Dict, workload: str, trace: bool) -> List[Dict]:
    """The metric entries this cell reports in a run of this kind."""
    group = bench_json["per_layer"] if trace else bench_json["end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def warm_buckets(drv: Driver, engine, vocab: int, seed: int) -> None:
    """One prefill step at each power-of-two bucket from the token
    budget down to 16 tokens, each followed by decode steps."""
    rng = np.random.default_rng((seed ^ 0x5EED) % (2 ** 63))
    budget = engine.scheduler._budget()
    chunk = engine.chunk_tokens
    t = 1 << (budget.bit_length() - 1)
    while t >= 16:
        n, size = (t // chunk, chunk) if t > chunk else (1, t)
        for _ in range(n):
            drv.submit(rng.integers(0, vocab, size).astype(np.int32), 2,
                       drv.clock())
        drv.drain()
        t //= 2


class Loop:
    """The mix's clients on one engine: ``tick()`` sends what is due (an
    open loop's arrivals; a closed loop's next request for each client
    whose last one finished) and runs one step."""

    def __init__(self, drv: Driver, traffic, mix: Dict):
        self.drv = drv
        self.closed = mix["loop"] == "closed"
        self.stream = traffic.requests()
        self.t_base = drv.clock()
        self.pending = None if self.closed else next(self.stream)
        self.rf = contextlib.nullcontext
        self.window_reqs: List = []
        self.in_window = False
        if self.closed:
            for _ in range(int(mix["clients"])):
                self._send(next(self.stream), drv.clock())

    def _send(self, spec, due: float):
        with self.rf("bench.submit"):
            rec = self.drv.submit(spec.prompt, spec.max_new, due)
        if self.in_window:
            self.window_reqs.append(rec)

    def tick(self, detail: bool = False):
        """Send what is due, then one engine step (None when idle)."""
        drv = self.drv
        if not self.closed:
            now = drv.clock()
            while self.t_base + self.pending.due <= now:
                self._send(self.pending, self.t_base + self.pending.due)
                self.pending = next(self.stream)
        if not drv.engine.has_work():
            if not self.closed:
                time.sleep(max(0.0, min(
                    0.002, self.t_base + self.pending.due - drv.clock())))
            return None
        with self.rf("bench.step"):
            st = drv.step(detail)
        if self.closed:
            for _ in drv.finished_now:
                self._send(next(self.stream), drv.clock())
        return st


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        device="cuda", root: Path = BENCH, strict: bool = True,
        t_start: Optional[float] = None, control: bool = False,
        bench_json: Optional[Dict] = None) -> Dict:
    """Run the cell once; returns the result line's dict plus, under
    ``"_check"`` and ``"_run"``, the check's readings and the run's
    record."""
    t_start = time.perf_counter() if t_start is None else t_start
    clock = time.perf_counter
    if bench_json is None:
        bench_json = load_json(root.parent / "BENCHMARK.json")
    entry = cell_entry(bench_json, workload)
    cfg = mc.load(entry["config"], root)
    mix = load_json(root / "mixes" / f"{entry['traffic']}.json")
    limits = load_json(root / "limits" / f"{workload}.json")
    method = limits.get("method", "sequence")
    if method not in ("sequence", "replay"):
        raise ValueError(f"unknown check method {method!r}")
    device = torch.device(device)
    eng_kw = dict(mix["engine"])
    traffic_lib.check_fits(mix, eng_kw["cache_len"])
    phases = {"start": clock() - t_start}

    def mark(name):
        _sync(device)
        phases[name] = clock() - t_start - sum(phases.values())

    from repro_torch.models.api import build_model
    from repro_torch.serving.engine import PagedDecodeEngine
    arch = mc.program_arch(cfg, strict=strict)
    api = build_model(arch)
    mark("program import")
    params = weights_lib.make(cfg, seed, device=device)
    mark("weights")
    engine = PagedDecodeEngine(api, params, window=mc.window(cfg),
                               device=device, **eng_kw)
    drv = Driver(engine, clock)
    vocab = cfg["vocab_size"]
    mark("engine")
    with torch.no_grad():
        warm_buckets(drv, engine, vocab, seed)
        mark("bucket warm-up")
        traffic = traffic_lib.Traffic(mix, vocab, seed)
        for ctx in traffic.contexts:            # shared contexts, cached
            drv.submit(ctx, 1, clock())
        drv.drain()
        drv.steps.clear()
        mark("contexts")
        loop = Loop(drv, traffic, mix)
        out = _window(loop, mix, seconds, trace, device)
        out.setup_s = out.t_open - t_start
        phases["warm traffic"] = out.setup_s - sum(phases.values())
        out.phases = phases
        if device.type == "cuda":
            dev = {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(device), "count": 1,
                   "memory_peak_bytes": int(
                       torch.cuda.max_memory_allocated(device))}
        else:
            dev = {"platform": "cpu", "kind": "cpu", "count": 0,
                   "memory_peak_bytes": 0}
        t_check = clock()
        if method == "replay":
            got = _replay(loop, cfg, params, mix, device, control)
    engine.on_token = None
    del engine, drv, loop
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out.cfg, out.mix, out.moe = cfg, mix, mc.is_moe(cfg)
    if method == "sequence":
        got = check_lib.sequence_check(cfg, params, out.requests,
                                       out.window, mix, seed, device=device,
                                       control=control)
    chk = check_lib.verdict(got, limits, out.failed)
    phases["check (after the window)"] = clock() - t_check
    if out.trace is not None:
        dev["busy_s"] = out.trace.busy_s()
        dev["window_s"] = out.trace.window_s
    metrics = {}
    for m in cell_metrics(bench_json, workload, trace):
        v = metric_reader(m["name"], root)(out)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {"correct": chk["correct"], "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": dev}
    if out.trace is not None:
        result["breakdown"] = {
            "device_ops": out.trace.top_ops(10),
            "idle_gaps": out.trace.idle_by_host(10, out.moe)}
    result["check"] = chk["numbers"]
    result["_check"] = chk
    result["_run"] = out
    return result


def _window(loop: Loop, mix: Dict, seconds: float, trace: bool,
            device: torch.device) -> SimpleNamespace:
    """Warm traffic, the window, and (open loop) the drain."""
    drv, clock = loop.drv, loop.drv.clock
    engine = drv.engine
    warm_s = float(mix.get("warm_s", 5.0))
    while clock() - loop.t_base < warm_s:
        loop.tick()
    _sync(device)
    prof = win = None
    if trace:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
        loop.rf = torch.profiler.record_function
        win = loop.rf("bench.window")
        win.__enter__()
    stats_open = engine.stats()
    t_open = clock()
    loop.in_window = True
    steps = []
    while clock() - t_open < seconds:
        st = loop.tick()
        if st is not None:
            steps.append(st)
    _sync(device)
    t_close = clock()
    loop.in_window = False
    stats_close = engine.stats()
    if prof is not None:
        win.__exit__(None, None, None)
        prof.__exit__(None, None, None)
        loop.rf = contextlib.nullcontext
    due = [r for r in loop.window_reqs if t_open <= r.due < t_close]
    if not loop.closed:
        while any(r.first is None for r in due) and \
                clock() - t_close < DRAIN_S:
            loop.tick()
    t_end = clock()
    tr = trace_lib.from_profiler(prof, HOST_RANGES) if prof else None
    failed = 0 if loop.closed else sum(1 for r in due if r.first is None)
    return SimpleNamespace(
        requests=list(drv.reqs.values()), window=(t_open, t_close),
        t_open=t_open, t_close=t_close, t_end=t_end, steps=steps,
        stats_open=stats_open, stats_close=stats_close, trace=tr,
        loop=mix["loop"], attempted=len(due), failed=failed,
        window_reqs=loop.window_reqs, setup_s=None, phases=None)


def _replay(loop: Loop, cfg: Dict, params: Dict, mix: Dict, device,
            control: bool) -> Dict[str, np.ndarray]:
    """The cache of every lane live at the window's close is checked
    against its request's tokens; then the traffic goes on, and each of
    the next steps is recomputed by the reference from the cache it ran
    on, until the mix's ``check.served_tokens`` emitted tokens are read
    (at most ``REPLAY_STEPS`` steps)."""
    reqs = loop.drv.reqs

    def history(rid):
        return [int(t) for t in reqs[rid].prompt] + reqs[rid].tokens
    parts: Dict[str, List[np.ndarray]] = {}
    got = check_lib.context_check(cfg, params, loop.drv.engine, history,
                                  device=device, control=control)
    for k, v in got.items():
        parts.setdefault(k, []).append(v)
    target = int(mix.get("check", {}).get("served_tokens", 320))
    n = steps = 0
    while n < target and steps < REPLAY_STEPS:
        st = loop.tick(detail=True)
        if st is None:
            if loop.closed:
                break
            continue
        steps += 1
        got = check_lib.replay(cfg, params, loop.drv.engine, st,
                               device=device, control=control)
        for k, v in got.items():
            parts.setdefault(k, []).append(v)
        n += got["gap"].size
    out = {k: np.concatenate(v) for k, v in parts.items()}
    out.setdefault("gap", np.zeros(0))
    out["replayed_steps"] = steps
    return out
