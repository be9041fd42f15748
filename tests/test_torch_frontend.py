"""The port's async frontend and open-loop harness (``serving/frontend.py``)
against the reference's, on the CPU.

Both packages serve gemma-7b's smoke config in float32, the port from the
reference's parameters converted, so their greedy tokens agree exactly.
The reference's cases (``tests/test_serving_frontend.py``) run through
both packages:

* **open loop** at light load and under overload with a TTFT target and a
  harness cancel.  Each package's :func:`run_open_loop` runs on a
  ``SimClock`` whose ``measure`` charges a fixed STEP_S and never opens
  the live window (in which ``now`` reads the host's clock), so every
  latency stamp is deterministic and the two returned dicts, records
  included, must be **equal**;
* **priority**: the last-submitted, higher-class request finishes first,
  with the reference's tokens;
* **streaming** through :class:`AsyncEngine` sinks, and an asyncio
  consumer that **disconnects**: the tokens streamed are the reference's,
  and the disconnect frees the request's KV;
* the **leak probe** of ``benchmarks/bench_serving.py`` (every request
  cancelled mid-flight on a host-swap engine whose pool is below the
  working set): every tier empty, the counters the reference's.

The port's step thread runs with grad mode off (it is thread-local).
Every wait carries a timeout (WAIT_S).
"""
import asyncio
import contextlib
import functools
import threading

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.simclock import SimClock
from repro_torch.models.api import build_model
from repro_torch.serving import (AsyncEngine, OpenRequest, PagedDecodeEngine,
                                 run_open_loop)

STEP_S = 0.01                 # the fixed charge of one engine step
WAIT_S = 300                  # every wait on a ticket or a stream


@functools.lru_cache(maxsize=None)
def _packages():
    """name -> (engine class, api, params, engine dtype options,
    SimClock, AsyncEngine, OpenRequest, run_open_loop): the reference's
    (``"jax"``) and the port's (``"torch"``), both float32, the port's
    parameters converted from the reference's init."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config
    from repro.core.simclock import SimClock as JaxSimClock
    from repro.models import build_model as jax_build_model
    from repro import serving as js
    from repro_torch.models.convert import from_reference_params
    japi = jax_build_model(jax_get_config("gemma-7b").smoke_variant())
    jparams = japi.init(jax.random.PRNGKey(0))
    tparams = from_reference_params(jax.tree.map(np.asarray, jparams),
                                    device="cpu", dtype=torch.float32)
    api = build_model(get_config("gemma-7b").smoke_variant())
    return {
        "jax": (js.PagedDecodeEngine, japi, jparams,
                dict(cache_dtype=jnp.float32, compute_dtype=jnp.float32),
                JaxSimClock, js.AsyncEngine, js.OpenRequest,
                js.run_open_loop),
        "torch": (PagedDecodeEngine, api, tparams,
                  dict(device="cpu", cache_dtype=torch.float32),
                  SimClock, AsyncEngine, OpenRequest, run_open_loop)}


def _engine(pkg, **kw):
    cls, api, params, dtypes = _packages()[pkg][:4]
    return cls(api, params, cache_len=64, **dtypes, **kw)


def _fixed_step_clock(pkg):
    """The package's SimClock, but ``measure`` charges STEP_S when the
    step ends and leaves ``now`` still inside it."""
    base = _packages()[pkg][4]

    class FixedStepClock(base):
        @contextlib.contextmanager
        def measure(self, label=""):
            yield
            self.advance(STEP_S, label, kind="real")

    return FixedStepClock()


def _prompts(n, seed=0, lo=4, hi=14):
    vocab = _packages()["torch"][1].cfg.vocab_size
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(lo, hi))).astype(np.int32)
            for _ in range(n)]


def _batch_tokens(pkg, prompts, max_new, **kw):
    eng = _engine(pkg, **kw)
    for p in prompts:
        eng.submit(p, max_new)
    return {r.request_id: list(r.generated) for r in eng.run_until_drained()}


def _light():
    """The reference's light load: 6 requests at seeded exponential gaps
    (mean 5 s) on 3 lanes, no SLO targets."""
    prompts = _prompts(6, seed=17)
    arrivals = np.cumsum(np.random.default_rng(17).exponential(5.0, 6))
    engine = dict(n_slots=3, block_size=4, chunk_tokens=8, prefix_cache=True)
    return engine, [(p, 6, float(t), None) for p, t in zip(prompts, arrivals)
                    ], {}


def _overload():
    """The reference's overload: 8 requests at t = 0 on one lane, a TTFT
    target no request can meet once it waits a step, and the first
    request cancelled by the harness right after it is admitted."""
    prompts = _prompts(8, seed=19, lo=8, hi=14)
    engine = dict(n_slots=1, block_size=4, chunk_tokens=4, prefix_cache=True)
    reqs = [(p, 8, 0.0, 1e-6 if i == 0 else None)
            for i, p in enumerate(prompts)]
    return engine, reqs, {"ttft_target": 1e-9}


@pytest.mark.parametrize("case", ["light", "overload"])
def test_open_loop_equals_reference(case):
    """The port's ``run_open_loop`` returns the reference's dict, records
    included, on the same schedule and clock; the tokens streamed through
    ``on_token`` are the reference's; the books balance and nothing is
    left on the engine."""
    engine_kw, reqs, targets = {"light": _light,
                                "overload": _overload}[case]()
    out, tokens, engines = {}, {}, {}
    for pkg in ("jax", "torch"):
        OpenReq, run = _packages()[pkg][6:8]
        eng = _engine(pkg, **engine_kw)
        toks = {}
        eng.on_token = lambda rid, tok, fin, toks=toks: toks.setdefault(
            rid, []).append(int(tok))
        out[pkg] = run(eng, [OpenReq(p, m, t_arrival=t, cancel_after=c)
                             for p, m, t, c in reqs],
                       clock=_fixed_step_clock(pkg), **targets)
        tokens[pkg], engines[pkg] = toks, eng
    assert out["torch"] == out["jax"]
    assert tokens["torch"] == tokens["jax"]
    o, eng = out["torch"], engines["torch"]
    n = len(reqs)
    assert o["offered"] == n
    assert o["completed"] + o["shed"] + o["cancelled"] == n
    assert not eng.scheduler.running and not eng.scheduler.waiting
    assert not eng.kv.take_swap_ins()
    if case == "light":
        assert o["completed"] == n and o["goodput_ratio"] == 1.0
        assert all(r["status"] == "ok" and r["ttft"] > 0 and r["tokens"] == 6
                   for r in o["records"])
        assert tokens["torch"] == _batch_tokens(
            "torch", [p for p, *_ in reqs], 6, **engine_kw)
    else:
        assert o["shed"] > 0 and o["cancelled"] == 1
        assert eng.shed == o["shed"] == eng.stats()["shed"]
        assert [r["status"] for r in o["records"]
                if r["request_id"] == 0] == ["cancelled"]


def test_priority_class_admits_first_as_the_reference():
    """Three same-size requests on one lane, the last submitted in a
    higher class: it finishes first, and every request's tokens are the
    reference's."""
    prompts = _prompts(3, seed=23, lo=6, hi=7)
    kw = dict(n_slots=1, block_size=4, chunk_tokens=8, prefix_cache=False)
    order, tokens = {}, {}
    for pkg in ("jax", "torch"):
        eng = _engine(pkg, **kw)
        for p, prio in zip(prompts, (0, 0, 5)):
            eng.submit(p, 4, priority=prio)
        fin = []
        for _ in range(200):
            eng.step()
            fin += eng.take_finished()
            if fin:
                break
        fin += eng.run_until_drained()
        order[pkg] = [r.request_id for r in fin]
        tokens[pkg] = {r.request_id: list(r.generated) for r in fin}
    assert order["torch"] == order["jax"] and order["torch"][0] == 2
    assert tokens["torch"] == tokens["jax"]


def _stream_with_sinks(pkg, prompts, kw):
    """Every prompt through the package's AsyncEngine with a sink; returns
    (tokens each sink received, each resolved request)."""
    Async = _packages()[pkg][5]
    eng = _engine(pkg, **kw)
    streamed = {i: [] for i in range(len(prompts))}
    with Async(eng) as fe:
        tickets = [fe.submit(p, 8, sink=lambda tok, fin, i=i: (
            tok is not None and streamed[i].append(int(tok))))
            for i, p in enumerate(prompts)]
        results = [fe.result(t, timeout=WAIT_S) for t in tickets]
    return streamed, results


def test_async_streaming_equals_reference():
    """Five concurrent requests through each package's AsyncEngine: the
    port's sinks receive, in order, the tokens its resolved requests hold,
    which are the reference's sinks' tokens."""
    prompts = _prompts(5, seed=11)
    kw = dict(n_slots=3, block_size=4, chunk_tokens=8, prefix_cache=True)
    want, _ = _stream_with_sinks("jax", prompts, kw)
    got, results = _stream_with_sinks("torch", prompts, kw)
    for i, r in enumerate(results):
        assert not r.cancelled and not r.shed
        assert got[i] == list(r.generated) == want[i]


def test_step_thread_runs_without_grad():
    """Grad mode is thread-local: the ``on_token`` hook, fired inside
    ``step()`` on the step thread, sees it off (the caller's thread has
    it on), and the pools the steps wrote stay ordinary tensors that the
    engine can write again after the frontend stops."""
    prompts = _prompts(2, seed=3)
    eng = _engine("torch", n_slots=2, block_size=4, chunk_tokens=8)
    seen = []

    def sink(tok, fin):
        seen.append((threading.current_thread().name,
                     torch.is_grad_enabled()))

    assert torch.is_grad_enabled()
    with AsyncEngine(eng) as fe:
        tickets = [fe.submit(p, 4, sink=sink) for p in prompts]
        for t in tickets:
            fe.result(t, timeout=WAIT_S)
    assert seen and set(seen) == {("async-engine-step", False)}
    assert not any(t.is_inference() for t in eng.cache["scan"].values())
    eng.submit(prompts[0], 4)
    assert list(eng.run_until_drained()[0].generated) == \
        list(tickets[0].result.generated)


def _disconnect(pkg, prompts, kw):
    """Two asyncio consumers of the package's AsyncEngine; the first
    disconnects after 3 tokens.  Returns (their tokens, the engine)."""
    Async = _packages()[pkg][5]
    eng = _engine(pkg, **kw)

    async def go():
        with Async(eng) as fe:
            async def consume(i, limit=None):
                toks = []
                async for tok in fe.stream(prompts[i], 12):
                    toks.append(int(tok))
                    if limit and len(toks) >= limit:
                        break        # disconnect: the generator closes
                return toks
            return await asyncio.wait_for(
                asyncio.gather(consume(0, limit=3), consume(1)), WAIT_S)

    return asyncio.run(go()), eng


def test_async_disconnect_equals_reference_and_frees_kv():
    """A consumer that disconnects mid-stream cancels its request; the
    survivor streams the reference's tokens, the disconnected stream is a
    prefix of the reference's, and the cancelled sequence's blocks return
    to the pool."""
    prompts = _prompts(2, seed=13, lo=8, hi=12)
    kw = dict(n_slots=2, block_size=4, chunk_tokens=8, prefix_cache=False)
    want = _batch_tokens("jax", prompts, 12, **kw)
    (got0, got1), eng = _disconnect("torch", prompts, kw)
    (ref0, ref1), _ = _disconnect("jax", prompts, kw)
    assert got1 == ref1 == want[1]
    assert got0 == ref0 == want[0][:3]
    assert eng.cancelled == 1 and eng.stats()["released_seqs"] == 1
    assert eng.kv.allocator.num_allocated == 0
    assert not eng.scheduler.running and not eng.scheduler.waiting


def _leak_probe(pkg):
    """``bench_serving._open_loop_leak_probe``'s shape: a fresh host-swap
    engine whose pool is below the working set, 5 requests sharing a
    block, every one cancelled after 6 steps (running and preempted
    alike).  Returns every tier's occupancy and the
    counters."""
    bs = 8
    vocab = _packages()["torch"][1].cfg.vocab_size
    rng = np.random.default_rng(13)
    shared = rng.integers(0, vocab, bs).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, vocab, 6)
                               .astype(np.int32)]) for _ in range(5)]
    need = max(-(-(len(p) + 32) // bs) for p in prompts)
    eng = _engine(pkg, n_slots=3, block_size=bs, chunk_tokens=bs,
                  prefix_cache=True, host_swap=True, num_blocks=need + 3)
    for p in prompts:                 # max_new large: nothing finishes
        eng.submit(p, 32)
    for _ in range(6):
        eng.step()
    cancelled = [eng.cancel(rid) for rid in range(len(prompts))]
    s = eng.stats()
    return {"has_work": eng.has_work(),
            "blocks_allocated": int(eng.kv.allocator.num_allocated),
            "prefix_cache_entries": len(eng.kv._cached),
            "host_tier_entries": len(eng._host_tier),
            "queued_swap_ins": len(eng.kv.take_swap_ins()),
            "cancel_returns": cancelled,
            **{k: s[k] for k in ("cancelled", "released_seqs",
                                 "swap_ins_dropped", "host_purged",
                                 "swap_outs", "preemptions")}}


def test_leak_probe_empties_every_tier_as_the_reference():
    got = _leak_probe("torch")
    assert got == _leak_probe("jax")
    assert not got["has_work"]
    assert all(got[k] == 0 for k in ("blocks_allocated",
                                     "prefix_cache_entries",
                                     "host_tier_entries", "queued_swap_ins"))
    assert got["cancel_returns"] == [True] * 5 and got["cancelled"] == 5
    assert got["preemptions"] > 0     # cancels hit preempted requests too
