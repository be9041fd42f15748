"""The paged engine's spans and counters (``serving/tracing.py``).

On the smoke configs, in float32 on the CPU: a span's self time leaves
out its children's, so the children of ``step`` and its remainder tile
the step's wall time; every swap-out is one ``swap_out`` span; the span
log exists only while ``torch.profiler`` records, stamped on the clock
of the profiler's own events; the queue-wait counters add up the
requests' own stamps; and the profiler changes no token.  On a card the
MoE layers' stages are timed with CUDA events while the profiler
records (``pytest -m cuda``).  No JAX here: the card runs this file
too.
"""
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models.api import build_model
from repro_torch.serving import tracing
from repro_torch.serving.engine import PagedDecodeEngine
from repro_torch.serving.tracing import SPANS, Tracer

KW = dict(n_slots=3, cache_len=64, block_size=4, chunk_tokens=8)
CPU_ONLY = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: the smoke steps are many small ops,
    and beside the suite's other workers more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(arch, device="cpu"):
    cfg = get_config(arch).smoke_variant()
    api = build_model(cfg)
    return cfg, api, api.init(seed=0, device=device, dtype=torch.float32)


@pytest.fixture(scope="module")
def dense():
    return _model("gemma-7b")


def _prompts(vocab, n, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(8, 17)))
            .astype(np.int32) for _ in range(n)]


def _engine(model, device="cpu", **kw):
    cfg, api, params = model
    eng = PagedDecodeEngine(api, params, window=api.effective_window(64),
                            device=device, **{**KW, **kw})
    eng.on_token = lambda rid, tok, finished: None
    return eng


def _drain(eng, prompts, max_new=8):
    for p in prompts:
        eng.submit(p, max_new)
    done = eng.run_until_drained()
    return {r.request_id: list(r.generated) for r in done}


def test_self_time_leaves_out_the_children(monkeypatch):
    """On a stepped clock: a parent's self time is its wall less its
    children's, a grandchild counts once, and the log keeps wall
    times."""
    ticks = iter([0, 10, 15, 20, 30, 60, 70, 100])
    monkeypatch.setattr(tracing, "stamp", lambda: next(ticks))
    monkeypatch.setattr(tracing, "profiling", lambda: True)
    tr = Tracer()
    tr.begin_step(7)
    with tr.span("step") as whole:
        with tr.span("schedule"):
            with tr.span("draft"):
                pass
        with tr.span("launch"):
            pass
    assert whole.ns == 100
    assert (tr.self_ns["step"], tr.self_ns["schedule"], tr.self_ns["draft"],
            tr.self_ns["launch"]) == (70, 15, 5, 10)
    assert sum(tr.self_ns.values()) == whole.ns
    assert tr.stats()["trace_spans"] == [
        ("draft", 15, 20, 7), ("schedule", 10, 30, 7),
        ("launch", 60, 70, 7), ("step", 0, 100, 7)]


def test_log_cap_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(tracing, "profiling", lambda: True)
    tr = Tracer()
    tr.cap = 2
    tr.begin_step(0)
    for _ in range(5):
        with tr.span("cow"):
            pass
    s = tr.stats()
    assert len(s["trace_spans"]) == 2 and s["trace_spans_dropped"] == 3
    assert s["span_n.cow"] == 5


def test_children_tile_the_step(dense):
    """The self times of every span add up to the wall time of the
    ``step()`` calls (within 1 %), and under the profiler to the logged
    ``step`` spans exactly."""
    eng = _engine(dense)
    for p in _prompts(dense[0].vocab_size, 5):
        eng.submit(p, 8)
    wall = 0
    while eng.has_work():
        t0 = time.perf_counter_ns()
        eng.step()
        wall += time.perf_counter_ns() - t0
    s = eng.stats()
    spanned = 1e9 * sum(s[f"span_s.{n}"] for n in SPANS)
    assert abs(spanned - wall) <= 0.01 * wall
    assert s["span_n.step"] == s["steps"]
    assert s["span_n.on_token"] == s["tokens_decoded"]
    assert s["span_n.draft"] > 0
    before = dict(eng.trace.self_ns)
    for p in _prompts(dense[0].vocab_size, 3, seed=6):
        eng.submit(p, 8)
    with torch.profiler.profile(activities=CPU_ONLY):
        eng.run_until_drained()
        log = eng.stats()["trace_spans"]
    added = sum(eng.trace.self_ns[n] - before[n] for n in SPANS)
    assert added == sum(e - s for n, s, e, _ in log if n == "step")
    assert {n for n, *_ in log} >= {"step", "schedule", "prepare",
                                    "launch", "readback", "verify"}


@pytest.fixture(scope="module")
def evicting(dense):
    """A pool well under the working set, drained: (stats before, stats
    after, the finished requests)."""
    prompts = _prompts(dense[0].vocab_size, 6, seed=37)
    need = max(-(-(len(p) + 8) // 4) for p in prompts)
    eng = _engine(dense, num_blocks=max(need + 1, (3 * need) // 2))
    before = eng.stats()
    for p in prompts:
        eng.submit(p, 8)
    done = eng.run_until_drained()
    return before, eng.stats(), done


def test_every_swap_out_is_one_span(evicting):
    before, after, _ = evicting
    assert after["preemptions"] > 0 and after["swap_outs"] > 0
    assert after["span_n.swap_out"] - before["span_n.swap_out"] \
        == after["swap_outs"] - before["swap_outs"]
    assert after["span_s.swap_out"] > 0


def test_queue_wait_adds_up_the_requests_stamps(evicting):
    """First admissions only: a preempted request re-admitted counts
    once, with its first wait."""
    _, after, done = evicting
    assert any(r.n_preemptions for r in done)
    assert after["admitted"] == len(done)
    assert all(r.t_submit <= r.t_admit <= r.t_first_token for r in done)
    assert after["queue_wait_s"] == pytest.approx(
        sum(r.t_admit - r.t_submit for r in done), rel=1e-9, abs=1e-12)


def test_log_only_while_the_profiler_records(dense):
    eng = _engine(dense)
    for p in _prompts(dense[0].vocab_size, 2):
        eng.submit(p, 8)
    eng.step()
    assert "trace_spans" not in eng.stats()
    with torch.profiler.profile(activities=CPU_ONLY):
        eng.step()
        s = eng.stats()
    assert s["trace_spans_dropped"] == 0
    assert [n for n, *_ in s["trace_spans"]][-1] == "step"
    assert {i for *_, i in s["trace_spans"]} == {1}
    eng.step()
    assert "trace_spans" not in eng.stats()


def test_log_is_stamped_on_the_profilers_clock():
    """A span opened around a ``record_function`` brackets the range's
    kineto stamps, with at most 1 ms of slack."""
    tr = Tracer()
    with torch.profiler.profile(activities=CPU_ONLY) as prof:
        tr.begin_step(0)
        with tr.span("step"):
            with torch.profiler.record_function("tracing.probe"):
                time.sleep(0.002)
        (_, t0, t1, _), = tr.stats()["trace_spans"]
    ev = next(e for e in prof.profiler.kineto_results.events()
              if e.name() == "tracing.probe")
    assert t0 - 1_000_000 <= ev.start_ns()
    assert ev.start_ns() + ev.duration_ns() <= t1 + 1_000_000


@pytest.mark.parametrize("arch", ["gemma-7b", "deepseek-moe-16b"])
def test_profiler_changes_no_token(arch):
    """The same fleet with the profiler off and on: equal greedy tokens;
    off the card no MoE stage is timed."""
    model = _model(arch)
    prompts = _prompts(model[0].vocab_size, 4)
    off = _drain(_engine(model), prompts)
    eng = _engine(model)
    with torch.profiler.profile(activities=CPU_ONLY):
        on = _drain(eng, prompts)
        s = eng.stats()
    assert on == off
    assert len(s["trace_spans"]) > 0
    assert (s["moe_traced_steps"], s["moe_ms.route"],
            s["moe_ms.dispatch"]) == (0, 0.0, 0.0)


@pytest.fixture
def cuda_device():
    """The first CUDA card; skips where there is none (decided here, at
    run time, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_moe_stages_timed_while_profiling(cuda_device):
    """On the card, every step under the profiler times the MoE route and
    dispatch stages from CUDA events; off it nothing is timed; the tokens
    are equal."""
    model = _model("deepseek-moe-16b", device=cuda_device)
    prompts = _prompts(model[0].vocab_size, 4)
    plain = _engine(model, device=cuda_device)
    off = _drain(plain, prompts)
    assert plain.stats()["moe_traced_steps"] == 0
    eng = _engine(model, device=cuda_device)
    acts = CPU_ONLY + [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        on = _drain(eng, prompts)
        s = eng.stats()
    assert on == off
    assert s["moe_traced_steps"] == s["steps"]
    assert s["moe_ms.route"] > 0 and s["moe_ms.dispatch"] > 0
    assert not eng.trace.moe.marks
