"""The port's serving engines, in float32 on the CPU.

Across frameworks: the port's ``PagedDecodeEngine`` emits the same greedy
tokens as the reference's with the same flags -- its defaults (ragged,
tiled, spec, prefix cache/CoW, host swap), the per-token read
(``tiled=False``) and the rectangular batch (``ragged=False``) -- from
parameters converted from the reference's ``init`` (the reference engine
built with float32 cache AND compute dtypes).  Inside the port: the paged
engine is token-identical to the dense ``SlotDecodeEngine`` under CoW,
host swap and cancel, in every layout where the test says so.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.serving import PagedDecodeEngine as JaxPagedEngine
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.api import build_model
from repro_torch.models.convert import from_reference_params
from repro_torch.serving.engine import (DecodeEngine, PagedDecodeEngine,
                                        ShardedDecodeEngine,
                                        SlotDecodeEngine)

PORT = dict(cache_dtype=torch.float32, device="cpu")
# the paged engine's three layouts: engine options and the expected
# (ragged, tiled) flags of its stats
LAYOUTS = {"default": ({}, (1, 1)),
           "per_token": ({"tiled": False}, (1, 0)),
           "rectangular": ({"ragged": False}, (0, 0))}


@pytest.fixture(scope="module", params=["gemma-7b", "starcoder2-7b"])
def model(request):
    arch = request.param
    jcfg = jax_get_config(arch).smoke_variant()
    japi = jax_build_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    tparams = from_reference_params(jax.tree.map(np.asarray, jparams),
                                    device="cpu", dtype=torch.float32)
    api = build_model(get_config(arch).smoke_variant())
    return arch, japi, jparams, api, tparams


def _prompts(vocab, n, lo, hi, seed, shared=0):
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, vocab, shared).astype(np.int32)
    return [np.concatenate([pre, rng.integers(
        0, vocab, int(rng.integers(lo, hi))).astype(np.int32)])
        for _ in range(n)]


def _drain(eng, prompts, max_new):
    for p in prompts:
        eng.submit(p, max_new)
    return {r.request_id: list(r.generated)
            for r in eng.run_until_drained()}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_paged_engine_matches_reference_engine(model, layout):
    """Greedy tokens equal the reference engine's with the same layout
    flags; starcoder2's requests run past its 64-token smoke window."""
    arch, japi, jparams, api, tparams = model
    flags, (ragged, tiled) = LAYOUTS[layout]
    window = api.effective_window(128)
    long_run = bool(window)
    prompts = _prompts(api.cfg.vocab_size, 3, 30 if long_run else 4,
                       40 if long_run else 12, seed=7, shared=8)
    max_new = 40 if long_run else 10
    kw = dict(n_slots=3, cache_len=128, window=window, **flags)
    ref = _drain(JaxPagedEngine(japi, jparams, cache_dtype=jnp.float32,
                                compute_dtype=jnp.float32, **kw),
                 prompts, max_new)
    eng = PagedDecodeEngine(api, tparams, **PORT, **kw)
    got = _drain(eng, prompts, max_new)
    assert got == ref
    if long_run:
        assert max(len(p) for p in prompts) + max_new > window
    s = eng.stats()
    assert (s["ragged"], s["tiled"]) == (ragged, tiled)
    assert s["spec"] == s["host_swap"] == 1
    assert s["spec_verifications"] > 0


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_paged_engine_matches_slot_engine_under_cow(model, layout):
    """A shared-prefix fleet (block-aligned exact repeats fork their tail
    block copy-on-write) against the dense oracle, in each layout."""
    arch, _, _, api, tparams = model
    window = api.effective_window(128)
    rng = np.random.default_rng(3)
    shared = rng.integers(0, api.cfg.vocab_size, 8).astype(np.int32)
    prompts = [shared, shared.copy()] + _prompts(
        api.cfg.vocab_size, 3, 2, 7, seed=4, shared=0)
    prompts[2:] = [np.concatenate([shared, p]) for p in prompts[2:]]
    kw = dict(n_slots=3, cache_len=64, window=window, **PORT)
    paged = PagedDecodeEngine(api, tparams, block_size=4, chunk_tokens=8,
                              **LAYOUTS[layout][0], **kw)
    slot = SlotDecodeEngine(api, tparams, **kw)
    paged.submit(prompts[0], 8)
    paged.step()
    paged.step()                 # the preamble's blocks are registered
    got = _drain(paged, prompts[1:], 8)
    got.update({r.request_id: list(r.generated)
                for r in paged.take_finished()})
    assert got == _drain(slot, prompts, 8)
    assert paged.kv.cow_copies > 0 and paged.cow_block_copies > 0
    assert paged.kv.prefix_hits > 0


def test_paged_engine_matches_slot_engine_under_host_swap(model):
    """A pool well under the concurrent working set: preempted chains
    come back from the host tier, tokens unchanged."""
    arch, _, _, api, tparams = model
    window = api.effective_window(128)
    prompts = _prompts(api.cfg.vocab_size, 6, 8, 16, seed=37, shared=4)
    need = max(-(-(len(p) + 8) // 4) for p in prompts)
    kw = dict(n_slots=3, cache_len=64, window=window, **PORT)
    paged = PagedDecodeEngine(api, tparams, block_size=4, chunk_tokens=8,
                              num_blocks=max(need + 1, (3 * need) // 2),
                              **kw)
    slot = SlotDecodeEngine(api, tparams, **kw)
    got = _drain(paged, prompts, 8)
    assert got == _drain(slot, prompts, 8)
    s = paged.stats()
    assert s["preemptions"] > 0
    assert s["swap_outs"] > 0 and s["swap_ins"] > 0


def test_cancel_mid_flight_matches_slot_engine_and_empties_pool(model):
    """Cancel one request mid-flight: the survivors match the dense
    oracle; cancelling the rest leaves the pool, the prefix cache and the
    host tier empty."""
    arch, _, _, api, tparams = model
    window = api.effective_window(128)
    prompts = _prompts(api.cfg.vocab_size, 3, 6, 12, seed=43, shared=8)
    kw = dict(n_slots=3, cache_len=64, window=window, **PORT)
    paged = PagedDecodeEngine(api, tparams, block_size=4, chunk_tokens=8,
                              **kw)
    for p in prompts:
        paged.submit(p, 10)
    for _ in range(40):
        paged.step()
        victim = next((r for r in paged.scheduler.running
                       if r.request_id == 0), None)
        if victim is not None and victim.generated:
            break
    assert paged.cancel(0)
    got = {r.request_id: list(r.generated)
           for r in paged.run_until_drained() if not r.cancelled}
    slot = SlotDecodeEngine(api, tparams, **kw)
    ref = _drain(slot, prompts, 10)
    assert set(got) == {1, 2} and all(got[k] == ref[k] for k in got)

    # the leak wall: cancel everything mid-flight
    eng = PagedDecodeEngine(api, tparams, block_size=4, chunk_tokens=8,
                            num_blocks=12, **kw)
    long_prompts = _prompts(api.cfg.vocab_size, 4, 6, 10, seed=53, shared=8)
    for p in long_prompts:
        eng.submit(p, 24)
    for _ in range(5):
        eng.step()
    for rid in range(len(long_prompts)):
        eng.cancel(rid)
    assert not eng.has_work()
    assert eng.kv.allocator.num_allocated == 0
    assert eng.kv.num_free_blocks == eng.num_blocks - 1
    assert len(eng._host_tier) == 0
    assert eng.cancelled == len(long_prompts)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_int8_pools_serve(model, layout):
    """int8 pools (quantized on write, dequantized in the read) serve
    every request in each layout; the reference's int8 engine with the
    same flags emits the same tokens."""
    arch, japi, jparams, api, tparams = model
    window = api.effective_window(128)
    prompts = _prompts(api.cfg.vocab_size, 3, 4, 12, seed=9, shared=4)
    kw = dict(n_slots=3, cache_len=64, window=window, **LAYOUTS[layout][0])
    ref = _drain(JaxPagedEngine(japi, jparams, cache_dtype=jnp.int8,
                                compute_dtype=jnp.float32, **kw),
                 prompts, 6)
    eng = PagedDecodeEngine(api, tparams, cache_dtype=torch.int8,
                            device="cpu", **kw)
    assert _drain(eng, prompts, 6) == ref
    assert eng.cache["scan"]["k"].dtype == torch.int8


def test_facade_and_unported_options(model, tmp_path):
    """The facade picks the paged engine, and with a data-parallel mesh
    (four CPU positions) the ``ShardedDecodeEngine``, which one
    ``PagedDecodeEngine`` refuses (``tests/test_torch_serving_sharded.py``
    holds mesh serving to the single engine); the KV transfer and
    persistence methods are ported (``tests/test_torch_kv_transfer.py``
    holds them to the reference): on an empty cache they export only the
    partial tail and snapshot nothing; a mismatched compute dtype
    raises."""
    arch, _, _, api, tparams = model
    kw = dict(n_slots=2, cache_len=32, **PORT)
    assert isinstance(DecodeEngine(api, tparams, **kw), PagedDecodeEngine)
    assert isinstance(DecodeEngine(api, tparams, paged=False, **kw),
                      SlotDecodeEngine)
    mesh = make_host_mesh(devices=[torch.device("cpu")] * 4)
    assert isinstance(DecodeEngine(api, tparams, mesh=mesh, **kw),
                      ShardedDecodeEngine)
    with pytest.raises(ValueError):
        PagedDecodeEngine(api, tparams, mesh=mesh, **kw)
    eng = PagedDecodeEngine(api, tparams, **kw)
    ship = eng.export_kv_prefix(np.arange(4, dtype=np.int32))
    assert (ship.n_blocks, ship.partial_tokens) == (0, [0, 1, 2, 3])
    assert eng.import_kv_shipment(ship)["imported"] == 0
    path = str(tmp_path / "prefix.kvship")
    assert eng.save_prefix_cache(path) > 0
    assert eng.load_prefix_cache(path)["imported"] == 0
    with pytest.raises(ValueError):
        PagedDecodeEngine(api, tparams, compute_dtype=torch.bfloat16, **kw)


def test_ragged_is_default_paged_layout(model):
    """The layout pins of the reference: ragged, tiled and spec by
    default; ``ragged=False`` turns tiling off with it, ``tiled=False``
    keeps the flat batch; tiling without the flat batch is refused."""
    arch, _, _, api, tparams = model
    kw = dict(n_slots=2, cache_len=64, **PORT)
    eng = DecodeEngine(api, tparams, **kw)
    assert isinstance(eng, PagedDecodeEngine)
    assert eng.ragged and eng.tiled and eng.spec
    rect = PagedDecodeEngine(api, tparams, ragged=False, **kw)
    assert not rect.ragged and not rect.tiled
    pertok = PagedDecodeEngine(api, tparams, tiled=False, **kw)
    assert pertok.ragged and not pertok.tiled
    with pytest.raises(ValueError):
        PagedDecodeEngine(api, tparams, ragged=False, tiled=True, **kw)
    assert not PagedDecodeEngine(api, tparams, draft_k=0, **kw).spec


def test_ragged_padding_efficiency_beats_rect_on_mixed_load(model):
    """On a staggered prefill+decode load the flat stream pads far fewer
    slots than the rectangle, with the same tokens out."""
    arch, _, _, api, tparams = model
    window = api.effective_window(64)
    prompts = _prompts(api.cfg.vocab_size, 8, 8, 16, seed=13)
    kw = dict(n_slots=4, cache_len=64, window=window, block_size=4,
              chunk_tokens=8, **PORT)
    out = {}
    for ragged in (True, False):
        eng = PagedDecodeEngine(api, tparams, ragged=ragged, **kw)
        pending = list(prompts)
        while pending or eng.scheduler.has_work():
            if pending:
                eng.submit(pending.pop(0), 8)
            eng.step()
        out[ragged] = (eng.stats()["padding_efficiency"],
                       {r.request_id: r.generated
                        for r in eng.take_finished()})
    assert out[True][1] == out[False][1]
    assert out[True][0] > out[False][0]
    assert out[True][0] >= 0.8
