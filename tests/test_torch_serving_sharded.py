"""Mesh serving of the port, in float32 on a CPU mesh of four positions.

The reference's wall (``tests/test_serving_sharded.py``) ported: a
tensor-parallel ``PagedDecodeEngine(mesh=)`` emits the single-device
engine's greedy tokens (tolerance: equal) with its pools cut over the kv
heads, and replicates them where the kv heads do not divide; the
data-parallel ``ShardedDecodeEngine`` routes to the least-loaded slice
and its dense fleet equals one engine, request for request; an MoE fleet
equals plain engines fed each slice's requests; KV exported from a TP
engine imports bit-identically into a single engine and back; and the
stats carry the per-slice lists and the collective counts.

Positions are ``torch.device("cpu")`` four times, the counterpart of the
reference's four virtual CPU devices: every shard runs its own layers at
the sharded shapes, and every reduce runs the code it runs across cards.
The port counts its reduces and gathers per step (``2 L + 2`` for a dense
model: one reduce after each cut attention and MLP, the embedding's
reduce and the logits' gather), where the reference counts collectives in
XLA's compiled step.  One case holds the port's TP engine against the
reference's single-device engine on the same converted parameters.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.serving import PagedDecodeEngine as JaxPagedEngine
from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import Mesh, build_mesh, make_host_mesh
from repro_torch.launch.specs import abstract_params
from repro_torch.models.api import build_model
from repro_torch.models.convert import from_reference_params
from repro_torch.serving.engine import (DecodeEngine, PagedDecodeEngine,
                                        ShardedDecodeEngine)
from repro_torch.serving.transfer import KVShipment

CPU = torch.device("cpu")
COMMON = dict(cache_len=64, cache_dtype=torch.float32, device="cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: the smoke engines run many small ops,
    and beside the suite's other workers more threads only contend for
    the cores (a tensor-parallel step, with tp times the ops, slowed
    ~50x that way)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(arch, **cfg_updates):
    cfg = dataclasses.replace(get_config(arch).smoke_variant(),
                              **cfg_updates)
    api = build_model(cfg)
    return cfg, api, api.init(seed=0, device="cpu", dtype=torch.float32)


@pytest.fixture(scope="module")
def model():
    return _params("gemma-7b")


@pytest.fixture(scope="module")
def moe_model():
    return _params("qwen3-moe-235b-a22b")


def _tp_mesh(tp):
    """One data slice x tp-way tensor parallel."""
    return Mesh([CPU] * tp, ("data", "model"), shape=(1, tp))


def _host_mesh(model_parallel=1):
    return make_host_mesh(model_parallel, devices=[CPU] * 4)


def _drain(eng, prompts, max_new=6, arrival_every=1):
    """Submit with optional staggering, run to empty, return {id: tokens}."""
    pending = list(prompts)
    step = 0
    while pending or eng.has_work():
        if pending and step % arrival_every == 0:
            eng.submit(pending.pop(0), max_new)
        eng.step()
        step += 1
        assert step < 2000, "engine did not drain"
    return {r.request_id: r.generated for r in eng.run_until_drained()}


def _prompts(cfg, n, seed=0, lo=4, hi=20):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size,
                         int(rng.integers(lo, hi))).astype(np.int32)
            for _ in range(n)]


def _design_count(cfg, plan) -> int:
    """The step's reduces and gathers by the step design: the embedding's
    reduce and the logits' gather, one reduce per cut sublayer (one per
    layer for a parallel block), and a gather of cut router logits."""
    n = int(plan.embed) + int(plan.head)
    for lp in plan.layers:
        ffn = [v for k, v in lp.items() if k not in ("attn", "router")]
        if cfg.parallel_block:
            n += int(lp["attn"] or any(ffn))
        else:
            n += int(lp["attn"]) + int(any(ffn))
        n += int(lp.get("router", False))
    return n


# ---------------------------------------------------------------------------
# tensor parallelism: one engine, sharded KV pool
# ---------------------------------------------------------------------------
def test_tp_engine_token_identical_and_actually_sharded(model):
    """tp=2 engine == single-device engine token for token, with the KV
    pools cut over the kv heads and reduces in every step: 2 L + 2 of
    them for the dense model (the reference's compiled step fuses its
    collectives to <= 3; the port counts its calls)."""
    cfg, api, params = model
    prompts = _prompts(cfg, 4, seed=1)
    ref = PagedDecodeEngine(api, params, n_slots=2, **COMMON)
    tp = PagedDecodeEngine(api, params, n_slots=2, mesh=_tp_mesh(2),
                           **COMMON)
    assert tp.tp == 2 and tp.kv_heads_sharded    # gemma smoke: 4 kv heads
    assert [c["scan"]["k"].shape[3] for c in tp._caches] == [2, 2]
    got_ref = _drain(ref, prompts)
    got_tp = _drain(tp, prompts)
    assert got_tp == got_ref
    s = tp.stats()
    assert s["collectives_per_step"] == 2 * cfg.n_layers + 2
    assert s["collective_ops"] == s["collectives_per_step"] * s["steps"]


def test_tp4_token_identical_over_all_devices(model):
    """Tensor parallelism over all four positions through the
    DecodeEngine factory stays a single (non-fleet) engine and
    matches."""
    cfg, api, params = model
    prompts = _prompts(cfg, 3, seed=2)
    ref = PagedDecodeEngine(api, params, n_slots=2, **COMMON)
    tp = DecodeEngine(api, params, paged=True, n_slots=2,
                      mesh=_host_mesh(model_parallel=4), **COMMON)
    assert isinstance(tp, PagedDecodeEngine) and tp.tp == 4
    assert _drain(tp, prompts) == _drain(ref, prompts)


def test_gqa_nondividing_kv_replicates_token_identical(moe_model):
    """qwen3-moe smoke has a single kv head: 1 % 2 != 0, so every
    position's pool holds it whole (kv_heads_sharded == 0), and the
    single-device tokens come out with the MoE shards live."""
    cfg, api, params = moe_model
    prompts = _prompts(cfg, 3, seed=3)
    ref = PagedDecodeEngine(api, params, n_slots=2, **COMMON)
    tp = PagedDecodeEngine(api, params, n_slots=2, mesh=_tp_mesh(2),
                           **COMMON)
    assert tp.tp == 2 and not tp.kv_heads_sharded
    assert _drain(tp, prompts) == _drain(ref, prompts)
    assert tp.stats()["collectives_per_step"] == \
        _design_count(cfg, tp._plan) > 0


# ---------------------------------------------------------------------------
# data parallelism: the sharded front
# ---------------------------------------------------------------------------
def test_dp_front_token_identical_to_single_engine(model):
    """Dense model, 4 slices, staggered arrivals: the fleet's outputs
    match the single-device engine request for request."""
    cfg, api, params = model
    prompts = _prompts(cfg, 6, seed=4)
    ref = PagedDecodeEngine(api, params, n_slots=2, **COMMON)
    dp = DecodeEngine(api, params, paged=True, n_slots=2,
                      mesh=_host_mesh(), **COMMON)
    assert isinstance(dp, ShardedDecodeEngine) and dp.n_slices == 4
    assert _drain(dp, prompts, arrival_every=2) == \
        _drain(ref, prompts, arrival_every=2)


def test_dp_tp_front_token_identical(model):
    """2 slices x 2-way TP (the full mesh shape) against the oracle."""
    cfg, api, params = model
    prompts = _prompts(cfg, 5, seed=5)
    ref = PagedDecodeEngine(api, params, n_slots=2, **COMMON)
    dptp = ShardedDecodeEngine(api, params, mesh=_host_mesh(2), n_slots=2,
                               **COMMON)
    assert dptp.n_slices == 2 and dptp.engines[0].tp == 2
    assert _drain(dptp, prompts) == _drain(ref, prompts)


def test_moe_dp_front_token_identity_per_slice(moe_model):
    """MoE + DP: capacity drops make logits depend on which requests
    share a batch, so the fleet need not match one whole-fleet engine;
    it must equal plain engines fed each slice's requests (the groups
    from the front's own routing table)."""
    cfg, api, params = moe_model
    prompts = _prompts(cfg, 6, seed=6)
    dp = ShardedDecodeEngine(api, params, mesh=_host_mesh(), n_slots=2,
                             **COMMON)
    gids = [dp.submit(p, 6) for p in prompts]
    got = {r.request_id: r.generated for r in dp.run_until_drained()}
    groups: dict = {}
    for gid in gids:                # gid order == per-slice local order
        groups.setdefault(dp._route[gid][0], []).append(gid)
    for i, members in groups.items():
        solo = PagedDecodeEngine(api, params, n_slots=2, **COMMON)
        lids = [solo.submit(prompts[g], 6) for g in members]
        mine = {r.request_id: r.generated
                for r in solo.run_until_drained()}
        for lid, gid in zip(lids, members):
            assert got[gid] == mine[lid], (
                f"slice {i} diverged from its single-device twin")


def test_least_loaded_routing_avoids_starvation_token_identical(model):
    """Round-robin would park a short request behind the long-running
    occupant of slice 0 while other slices idle; least-loaded routing
    sends every short to an idle slice, and the dense fleet still
    matches the single-device oracle."""
    cfg, api, params = model
    rng = np.random.default_rng(10)
    long_p = rng.integers(0, cfg.vocab_size, 30).astype(np.int32)
    shorts = [rng.integers(0, cfg.vocab_size, 4).astype(np.int32)
              for _ in range(4)]
    dp = DecodeEngine(api, params, paged=True, n_slots=2,
                      mesh=_host_mesh(), **COMMON)
    assert isinstance(dp, ShardedDecodeEngine) and dp.n_slices == 4
    g_long = dp.submit(long_p, 24)
    assert dp._route[g_long][0] == 0      # empty fleet: lowest index
    g_shorts = [dp.submit(p, 4) for p in shorts]
    assert all(dp._route[g][0] != 0 for g in g_shorts)
    assert {dp._route[g][0] for g in g_shorts} == {1, 2, 3}
    got = {r.request_id: r.generated for r in dp.run_until_drained()}
    ref = PagedDecodeEngine(api, params, n_slots=2, **COMMON)
    ref.submit(long_p, 24)
    for p in shorts:
        ref.submit(p, 4)
    want = {r.request_id: r.generated for r in ref.run_until_drained()}
    assert got == want


# ---------------------------------------------------------------------------
# transfer across sharding boundaries
# ---------------------------------------------------------------------------
def test_sharded_export_import_roundtrip_token_identical(model):
    """KV prefill exported from a tp=2 engine imports bit-identically
    into a single-device engine (and the reverse), and the importer
    serves the warm prompt with a prefix hit and unchanged tokens."""
    cfg, api, params = model
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, cfg.vocab_size, 37).astype(np.int32)

    src = PagedDecodeEngine(api, params, n_slots=2, mesh=_tp_mesh(2),
                            **COMMON)
    src.submit(prompt, 1)
    src.run_until_drained()
    ship = src.export_kv_prefix(prompt)
    assert ship.n_blocks == 37 // src.block_size
    back = KVShipment.deserialize(ship.serialize())

    dst = PagedDecodeEngine(api, params, n_slots=2, **COMMON)
    stats = dst.import_kv_shipment(back)
    assert stats["imported"] == ship.n_blocks
    for rec in ship.blocks:
        got = dst._read_block_payload(dst.kv.digest_block(rec.digest))
        for part in rec.payload:
            for kv in ("k", "v"):
                assert torch.equal(got[part][kv], rec.payload[part][kv])
    cold = PagedDecodeEngine(api, params, n_slots=2, **COMMON)
    assert _drain(dst, [prompt]) == _drain(cold, [prompt])
    assert dst.kv.prefix_hits > 0

    plain = PagedDecodeEngine(api, params, n_slots=2, **COMMON)
    plain.submit(prompt, 1)
    plain.run_until_drained()
    ship2 = plain.export_kv_prefix(prompt)
    dst2 = PagedDecodeEngine(api, params, n_slots=2, mesh=_tp_mesh(2),
                             **COMMON)
    s2 = dst2.import_kv_shipment(KVShipment.deserialize(ship2.serialize()))
    assert s2["imported"] == ship2.n_blocks
    # the shards hold the payload's kv heads, split along them
    rec = ship2.blocks[0]
    blk = dst2.kv.digest_block(rec.digest)
    for s, c in enumerate(dst2._caches):
        assert torch.equal(c["scan"]["k"][:, blk],
                           rec.payload["scan"]["k"][:, :, 2 * s:2 * s + 2])
    cold2 = PagedDecodeEngine(api, params, n_slots=2, **COMMON)
    assert _drain(dst2, [prompt]) == _drain(cold2, [prompt])
    assert dst2.kv.prefix_hits > 0


def test_sharded_front_import_is_fleet_wide(model):
    """A shipment imported through the front lands on every slice, so
    any route serves the prefix warm; the digests every slice holds form
    the safe dedup set."""
    cfg, api, params = model
    rng = np.random.default_rng(8)
    prompt = rng.integers(0, cfg.vocab_size, 24).astype(np.int32)
    src = PagedDecodeEngine(api, params, n_slots=2, **COMMON)
    src.submit(prompt, 1)
    src.run_until_drained()
    ship = src.export_kv_prefix(prompt)

    dp = ShardedDecodeEngine(api, params, mesh=_host_mesh(), n_slots=2,
                             **COMMON)
    stats = dp.import_kv_shipment(ship)
    assert stats["imported"] == ship.n_blocks * dp.n_slices
    assert dp.cached_digests() == {b.digest for b in ship.blocks}
    cold = PagedDecodeEngine(api, params, n_slots=2, **COMMON)
    want = _drain(cold, [prompt] * dp.n_slices)
    assert _drain(dp, [prompt] * dp.n_slices) == want
    assert all(e.kv.prefix_hits > 0 for e in dp.engines)


# ---------------------------------------------------------------------------
# stats contract
# ---------------------------------------------------------------------------
def test_sharded_stats_report_per_slice_and_collectives(model):
    """stats() exposes the per-slice breakdown, and the lists sum to the
    aggregates; a single engine's stats carry the same accounting keys,
    tp=1 and zeros off the mesh."""
    cfg, api, params = model
    dp = ShardedDecodeEngine(api, params, mesh=_host_mesh(2), n_slots=2,
                             **COMMON)
    _drain(dp, _prompts(cfg, 4, seed=9))
    s = dp.stats()
    assert s["slices"] == 2 and s["tp"] == 2
    assert s["tokens_decoded"] == sum(s["tokens_decoded_per_slice"])
    assert s["tokens_prefilled"] == sum(s["tokens_prefilled_per_slice"])
    assert s["collective_ops"] == sum(s["collective_ops_per_slice"])
    assert all(t > 0 for t in s["tokens_decoded_per_slice"])
    assert len(s["per_slice"]) == 2
    assert all(p["tp"] == 2 for p in s["per_slice"])
    tp = PagedDecodeEngine(api, params, n_slots=2, mesh=_tp_mesh(2),
                           **COMMON)
    for k in ("tp", "kv_heads_sharded", "collectives_per_step",
              "collective_ops"):
        assert k in tp.stats()
    off = PagedDecodeEngine(api, params, n_slots=2, **COMMON).stats()
    assert (off["tp"], off["kv_heads_sharded"], off["collectives_per_step"],
            off["collective_ops"]) == (1, 0, 0, 0)


# ---------------------------------------------------------------------------
# beyond the reference's wall
# ---------------------------------------------------------------------------
def test_tp2_engine_matches_reference_single_device_engine():
    """Across frameworks: the port's tp=2 engine, on parameters converted
    from the reference's init, drains the reference's single-device
    engine's greedy tokens (both in float32)."""
    jcfg = jax_get_config("gemma-7b").smoke_variant()
    japi = jax_build_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    tparams = from_reference_params(jax.tree.map(np.asarray, jparams),
                                    device="cpu", dtype=torch.float32)
    api = build_model(get_config("gemma-7b").smoke_variant())
    prompts = _prompts(api.cfg, 4, seed=11)
    ref = JaxPagedEngine(japi, jparams, n_slots=2, cache_len=64,
                         cache_dtype=jnp.float32, compute_dtype=jnp.float32)
    tp = PagedDecodeEngine(api, tparams, n_slots=2, mesh=_tp_mesh(2),
                           **COMMON)
    assert _drain(tp, prompts) == _drain(ref, prompts)


@pytest.mark.parametrize("arch,layout", [
    ("gemma-7b", {"tiled": False}), ("gemma-7b", {"ragged": False}),
    ("starcoder2-7b", {}), ("command-r-35b", {}),
    ("deepseek-moe-16b", {}), ("deepseek-moe-16b", {"ragged": False}),
    ("llava-next-mistral-7b", {})])
def test_tp_layouts_and_families_token_identical_with_design_count(arch,
                                                                   layout):
    """Each layout and each paged family at tp 2 and 4 against its own
    tp 1 engine: the per-token and rectangular reads, biases added once
    after the reduce (starcoder2), the parallel block's single reduce
    (command-r), the MoE's gathered router logits with shared experts,
    a dense first layer and capacity drops (deepseek-moe) and the VLM's
    backbone; each step's collectives are the design's count."""
    cfg, api, params = _params(arch)
    prompts = _prompts(cfg, 4, seed=12)
    want = _drain(PagedDecodeEngine(api, params, n_slots=2, **layout,
                                    **COMMON), prompts)
    for tp in (2, 4):
        eng = PagedDecodeEngine(api, params, n_slots=2, mesh=_tp_mesh(tp),
                                **layout, **COMMON)
        assert _drain(eng, prompts) == want, tp
        assert eng.stats()["collectives_per_step"] == \
            _design_count(cfg, eng._plan) > 0


def test_tp_int8_pools_token_identical(model):
    """int8 pools cut over the kv heads quantize each (token, kv head)
    as one device does: tp 2 and 4 drain the tp 1 int8 engine's tokens,
    and their pools hold its codes to within one step (the shards' K/V
    products round differently from the whole product in float32's last
    bit, which can move a code across a rounding edge) and its scales to
    float32 rounding."""
    cfg, api, params = model
    prompts = _prompts(cfg, 4, seed=13)
    kw = dict(COMMON, cache_dtype=torch.int8)
    one = PagedDecodeEngine(api, params, n_slots=2, **kw)
    want = _drain(one, prompts)
    for tp in (2, 4):
        eng = PagedDecodeEngine(api, params, n_slots=2, mesh=_tp_mesh(tp),
                                **kw)
        assert _drain(eng, prompts) == want
        assert eng.cache["scan"]["k"].dtype == torch.int8
        whole = {name: torch.cat([c["scan"][name] for c in eng._caches],
                                 dim=3) for name in ("k", "k_scale")}
        assert (whole["k"].int() - one.cache["scan"]["k"].int()).abs() \
            .max() <= 1
        torch.testing.assert_close(whole["k_scale"],
                                   one.cache["scan"]["k_scale"],
                                   rtol=1e-5, atol=0)


def test_kv_head_slices_and_straddling_heads():
    """Where the kv heads do not divide tp but a position's q heads share
    one kv group (8 q / 2 kv heads at tp 4), each position's pool holds
    that one kv head and the tokens are tp 1's; where a position's q
    heads would straddle two groups (12 q / 3 kv heads at tp 4), the
    plan refuses."""
    cfg, api, params = _params("gemma-7b", n_heads=8, n_kv_heads=2)
    eng = PagedDecodeEngine(api, params, n_slots=2, mesh=_tp_mesh(4),
                            **COMMON)
    assert eng._plan.kv == [(0, 1), (0, 1), (1, 2), (1, 2)]
    assert eng.kv_heads_sharded
    prompts = _prompts(cfg, 3, seed=14)
    assert _drain(eng, prompts) == _drain(
        PagedDecodeEngine(api, params, n_slots=2, **COMMON), prompts)
    bad = build_model(dataclasses.replace(
        get_config("gemma-7b").smoke_variant(), n_heads=12, n_kv_heads=3))
    specs = sh.serving_param_specs(abstract_params(bad), {"model": 4})
    with pytest.raises(ValueError, match="straddle"):
        bad.tp_plan(specs, [CPU] * 4)


def test_mesh_refusals(model):
    """dp > 1 into one paged engine, a family without paged decode, and a
    launcher mesh larger than the devices present are refused."""
    cfg, api, params = model
    with pytest.raises(ValueError, match="data-parallel"):
        PagedDecodeEngine(api, params, n_slots=2, mesh=_host_mesh(2),
                          **COMMON)
    _, zapi, zparams = _params("zamba2-2.7b")
    with pytest.raises(ValueError, match="paged"):
        DecodeEngine(zapi, zparams, n_slots=2, mesh=_tp_mesh(2), **COMMON)
    with pytest.raises(SystemExit, match="needs 16 devices"):
        build_mesh("4,4", 0, "cuda")


def test_serve_launcher_on_a_cpu_mesh(capsys):
    """``--mesh-shape 2,2 --device cpu`` serves through the sharded front
    of two tensor-parallel slices."""
    serve_launcher.main(["--arch", "gemma-7b", "--device", "cpu",
                         "--mesh-shape", "2,2", "--requests", "4",
                         "--max-new", "4"])
    out = capsys.readouterr().out
    assert "engine=ShardedDecodeEngine" in out and "'tp': 2" in out
    assert out.strip().endswith("done")
