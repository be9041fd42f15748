"""The readers of the program's spans and counters (``stats()``'s
``span_s.*``, ``moe_ms.*``, ``queue_wait_s``, and the span log under
``trace_spans``) on hand-made runs: a window's two ``stats()``
snapshots, and a device trace beside a span log."""
import json
from types import SimpleNamespace

import pytest

from bench.harness import trace as trace_lib
from bench.harness.cell import metric_reader
from bench.tests.smoke import BENCH

PER_STEP = {
    "schedule_ms_per_step": ("span_s.schedule",),
    "swap_ms_per_step": ("span_s.swap_out", "span_s.swap_in"),
    "draft_ms_per_step": ("span_s.draft",),
    "prepare_ms_per_step": ("span_s.prepare",),
    "launch_ms_per_step": ("span_s.launch",),
    "readback_ms_per_step": ("span_s.readback",),
    "verify_ms_per_step": ("span_s.verify",),
}
SPAN_LOG = ("idle_in_launch_share", "idle_unspanned_share")
NEW = (*PER_STEP, *SPAN_LOG, "moe_route_ms_per_step",
       "moe_dispatch_ms_per_step", "queue_wait_ms")
S = 1_000_000_000                       # ns a second


def _run(stats_open, stats_close, trace=None):
    return SimpleNamespace(stats_open=stats_open, stats_close=stats_close,
                           trace=trace)


@pytest.mark.parametrize("name", sorted(PER_STEP))
def test_per_step_span_readers(name):
    """4 steps; each span's self time grew by 0.2 s (swap: 0.2 s out and
    0.2 s in): 50 ms a step, 100 for the swap tier's two spans."""
    keys = PER_STEP[name]
    a = {"steps": 10, **{k: 1.0 for k in keys}}
    b = {"steps": 14, **{k: 1.2 for k in keys}}
    got = metric_reader(name)(_run(a, b))
    assert got == pytest.approx(50.0 * len(keys))


@pytest.mark.parametrize("name", NEW)
def test_readers_find_nothing_without_the_counters(name):
    """A program without the spans (the parent's ``stats()``) reads
    None, traced or not."""
    a = {"steps": 10, "tokens_decoded": 5}
    b = {"steps": 14, "tokens_decoded": 9}
    tr = trace_lib.Trace(ops=[("k", 1.0, 2.0)], host=[], lo=0.0, hi=3.0)
    assert metric_reader(name)(_run(a, b)) is None
    assert metric_reader(name)(_run(a, b, tr)) is None


def test_moe_stage_readers():
    a = {"moe_ms.route": 10.0, "moe_ms.dispatch": 4.0,
         "moe_traced_steps": 2}
    b = {"moe_ms.route": 40.0, "moe_ms.dispatch": 24.0,
         "moe_traced_steps": 6}
    assert metric_reader("moe_route_ms_per_step")(_run(a, b)) == 7.5
    assert metric_reader("moe_dispatch_ms_per_step")(_run(a, b)) == 5.0
    b["moe_traced_steps"] = 2                   # a dense model, or no card
    assert metric_reader("moe_route_ms_per_step")(_run(a, b)) is None


def test_queue_wait_reader():
    a = {"queue_wait_s": 1.0, "admitted": 3}
    b = {"queue_wait_s": 1.9, "admitted": 6}
    assert metric_reader("queue_wait_ms")(_run(a, b)) == pytest.approx(300.0)


def _traced():
    """Window 0.5-5.0 s; the device busy 1.0-2.0 and 3.0-4.0, so idle
    0.5-1.0, 2.0-3.0 and 4.0-5.0.  Two steps: the first 0.6-2.6 with
    ``schedule`` 0.6-0.8 (a swap-out inside it), ``launch`` 1.5-2.5; the
    second 2.8-4.9 with ``launch`` 2.8-3.3 and ``readback`` 3.3-4.5."""
    tr = trace_lib.Trace(ops=[("k", 1.0, 2.0), ("k", 3.0, 4.0)], host=[],
                         lo=0.5, hi=5.0)
    log = [("swap_out", 0.65 * S, 0.7 * S, 0),
           ("schedule", 0.6 * S, 0.8 * S, 0),
           ("launch", 1.5 * S, 2.5 * S, 0),
           ("step", 0.6 * S, 2.6 * S, 0),
           ("launch", 2.8 * S, 3.3 * S, 1),
           ("readback", 3.3 * S, 4.5 * S, 1),
           ("step", 2.8 * S, 4.9 * S, 1)]
    log = [(n, int(s), int(e), i) for n, s, e, i in log]
    return _run({"steps": 0}, {"steps": 2, "trace_spans": log}, tr)


def test_idle_in_launch_share():
    """The launch spans meet the idle stretches in 2.0-2.5 (the first
    launch only partly idle) and 2.8-3.0: 0.7 s of the 4.5 s window."""
    got = metric_reader("idle_in_launch_share")(_traced())
    assert got == pytest.approx(100.0 * 0.7 / 4.5)


def test_idle_unspanned_share():
    """The steps less their children: 0.8-1.5, 2.5-2.6 and 4.5-4.9; of
    that idle: 0.8-1.0, 2.5-2.6 and 4.5-4.9, 0.7 s of the 4.5 s
    window."""
    got = metric_reader("idle_unspanned_share")(_traced())
    assert got == pytest.approx(100.0 * 0.7 / 4.5)


def test_new_metrics_are_reported_where_their_end_to_end_metric_is():
    """Each new metric lists its cells, and each of them reports the
    end-to-end metric it moves."""
    bj = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    e2e = {m["name"]: m for m in bj["end_to_end"]}
    per = {m["name"]: m for m in bj["per_layer"]}
    cells = {w["name"] for w in bj["workloads"]}
    for name in NEW:
        m = per[name]
        assert m["workloads"] and set(m["workloads"]) <= cells
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
