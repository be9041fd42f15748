"""The port's MoE family (deepseek-moe-16b, moonshot-v1-16b-a3b,
qwen3-moe-235b-a22b) and command-r-35b against the reference, in float32
on the CPU: parameters converted from the reference's ``init``, inputs
made with numpy from a seed.

Routing is discrete, so routes are compared as well as outputs: each
token's top-k experts as a set (``torch.topk`` and ``jax.lax.top_k`` may
order equal values differently; a near-tie is reported, not re-seeded
around) and each expert's capacity slots as the ordered list of tokens
that hold them.  With drops, a token's route depends on every earlier
token of its capacity group, padding included, so the paged engine is
held to the reference's paged engine at the published capacity factor,
and to the slot engine only at ``capacity_factor=8.0`` (no drops), as
``tests/test_decode_consistency.py`` does in the reference.
"""
import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import moe as jax_moe
from repro.models import transformer as jax_tf
from repro.serving import PagedDecodeEngine as JaxPagedEngine
from repro_torch.configs import get_config
from repro_torch.models import moe
from repro_torch.models.api import build_model
from repro_torch.models.convert import from_reference_params
from repro_torch.serving.engine import PagedDecodeEngine, SlotDecodeEngine

MOE_ARCHS = ["deepseek-moe-16b", "moonshot-v1-16b-a3b",
             "qwen3-moe-235b-a22b"]
# float32 on both sides, contracting in different orders: one MoE layer's
# output agrees to ~1e-6, two layers' logits to a few 1e-6 (command-r's
# and the MoE smoke stacks read 1e-6 to 3e-6 max abs)
ATOL = RTOL = 1e-4
# a top-k boundary closer than this is a tie the two top-k's may break
# differently: reported, and that token's route left out of the compare
TIE = 1e-6
PORT = dict(cache_dtype=torch.float32, device="cpu")
LAYOUTS = {"default": {}, "per_token": {"tiled": False},
           "rectangular": {"ragged": False}}


def _cfgs(arch, capacity_factor=None):
    jcfg, cfg = jax_get_config(arch).smoke_variant(), \
        get_config(arch).smoke_variant()
    if capacity_factor is not None:
        jcfg, cfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=capacity_factor)) for c in (jcfg, cfg))
    return jcfg, cfg


@functools.lru_cache(maxsize=None)
def _models(arch, capacity_factor=None):
    jcfg, cfg = _cfgs(arch, capacity_factor)
    japi = jax_build_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    tparams = from_reference_params(jax.tree.map(np.asarray, jparams),
                                    device="cpu", dtype=torch.float32)
    return jcfg, japi, jparams, cfg, build_model(cfg), tparams


@pytest.mark.parametrize("arch", MOE_ARCHS + ["command-r-35b"])
def test_configs_match_reference(arch):
    """The port's config copies equal the reference's, full and smoke."""
    for smoke in (False, True):
        j, t = jax_get_config(arch), get_config(arch)
        if smoke:
            j, t = j.smoke_variant(), t.smoke_variant()
        # nested configs are each package's own dataclass: compare fields
        assert dataclasses.asdict(t) == dataclasses.asdict(j), (arch, smoke)


@pytest.mark.parametrize("arch", MOE_ARCHS + ["command-r-35b"])
def test_init_params_tree_matches_reference(arch):
    """The port's own init makes the reference's tree (``head_blocks`` a
    list, the expert stacks, the shared experts): same paths and shapes,
    weights in the compute dtype, norms float32; the expert weights have
    the reference's fan-in scales."""
    jcfg, cfg = _cfgs(arch)
    jtree = jax.eval_shape(lambda: jax_build_model(jcfg).init(
        jax.random.PRNGKey(0)))
    tparams = build_model(cfg).init(seed=0, device="cpu",
                                    dtype=torch.bfloat16)
    jflat = {jax.tree_util.keystr(k): v.shape for k, v in
             jax.tree_util.tree_flatten_with_path(jtree)[0]}
    tflat = {jax.tree_util.keystr(k): v for k, v in
             jax.tree_util.tree_flatten_with_path(tparams)[0]}
    assert set(jflat) == set(tflat)
    for k, shape in jflat.items():
        assert tuple(tflat[k].shape) == tuple(shape), k
        want = torch.float32 if "norm" in k else torch.bfloat16
        assert tflat[k].dtype == want, k
    if cfg.moe is not None:
        d, h = cfg.d_model, cfg.moe.d_expert
        # a truncated normal cut at 2 std has std 0.8796 x its scale
        for leaf, fan_in in (("experts_w_up", d), ("experts_w_down", h),
                             ("router", d)):
            std = tflat[f"['blocks']['moe']['{leaf}']"].float().std().item()
            assert abs(std * fan_in ** 0.5 / 0.8796 - 1) < 0.05, leaf


def test_route_topk_and_expert_capacity():
    """``route_topk`` gives the reference's gates and expert sets, and
    ``expert_capacity`` its capacities."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 7, 16)).astype(np.float32) * 3
    jg, ji = jax_moe.route_topk(jnp.asarray(logits), 4)
    tg, ti = moe.route_topk(torch.from_numpy(logits), 4)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6)
    np.testing.assert_array_equal(np.sort(ti.numpy(), -1),
                                  np.sort(np.asarray(ji), -1))
    np.testing.assert_allclose(tg.sum(-1).numpy(), 1.0, atol=1e-6)
    for arch in MOE_ARCHS:
        for cf in (0.26, 1.25, 8.0):
            jmo = dataclasses.replace(jax_get_config(arch).moe,
                                      capacity_factor=cf)
            tmo = dataclasses.replace(get_config(arch).moe,
                                      capacity_factor=cf)
            for n in (1, 5, 16, 256, 4096):
                assert moe.expert_capacity(n, tmo) == \
                    jax_moe.expert_capacity(n, jmo)


def _slots_from_routes(idx, C, E):
    """Each (group, expert)'s capacity slots, in order: the tokens that
    hold them.  A token claims an expert at most once, so the order is
    the token order whatever order top-k lists a token's experts in."""
    out = []
    for g in range(idx.shape[0]):
        per_e = [[] for _ in range(E)]
        for s in range(idx.shape[1]):
            for e in idx[g, s]:
                per_e[int(e)].append(s)
        out.append([lst[:C] for lst in per_e])
    return out


def _ties(probs, k):
    """(group, token) pairs whose k-th and (k+1)-th probabilities are
    within TIE of each other."""
    top = np.sort(probs, -1)[..., ::-1]
    if top.shape[-1] <= k:
        return set()
    return {tuple(i) for i in np.argwhere(top[..., k - 1] - top[..., k]
                                          < TIE)}


@pytest.mark.parametrize("cf", [1.25, 0.26])
@pytest.mark.parametrize("impl", ["gshard", "gather"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_apply_moe_matches_reference(arch, impl, cf):
    """One MoE layer on (2, 16, d) float32 inputs, at the published
    capacity factor and at 0.26 (``tests/test_moe_impls.py``'s dropping
    case): y, aux, each token's expert set and each expert's capacity
    slots equal the reference's; at 0.26 tokens are dropped."""
    jcfg, cfg = _cfgs(arch, cf)
    jcfg, cfg = (dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, impl=impl)) for c in (jcfg, cfg))
    jp = jax_moe.moe_params(jax.random.PRNGKey(3), jcfg)
    tp = from_reference_params(jax.tree.map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(1).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    jy, jaux = jax_moe.apply_moe(jp, jnp.asarray(x), jcfg)
    ty, taux = moe.apply_moe(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)

    mo = cfg.moe
    C = moe.expert_capacity(16, mo)
    logits = np.asarray(jnp.einsum("gsd,de->gse", jnp.asarray(x),
                                   jp["router"]))
    _, jidx = jax_moe.route_topk(jnp.asarray(logits), mo.experts_per_token)
    _, tidx, _, _, keep, _ = moe._route(
        moe.router_logits(tp, torch.from_numpy(x)), mo, C)
    ties = _ties(np.asarray(jax.nn.softmax(logits)), mo.experts_per_token)
    if ties:
        warnings.warn(f"{arch}: top-k ties at (group, token) {sorted(ties)}"
                      " left out of the route compare")
    for g in range(2):
        for s in range(16):
            if (g, s) not in ties:
                assert set(tidx[g, s].tolist()) == \
                    set(np.asarray(jidx)[g, s].tolist()), (g, s)
    if not ties:
        assert _slots_from_routes(tidx.numpy(), C, mo.n_experts) == \
            _slots_from_routes(np.asarray(jidx), C, mo.n_experts)
    dropped = int(16 * 2 * mo.experts_per_token - keep.sum().item())
    if cf < 1:
        assert dropped > 0


@pytest.mark.parametrize("cf", [1.25, 0.26])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_gshard_matches_gather(arch, cf):
    """Inside the port the two dispatches agree, drops included."""
    _, cfg = _cfgs(arch, cf)
    tp = moe.moe_params(cfg, 1, torch.Generator().manual_seed(0),
                        device="cpu", dtype=torch.float32)
    tp = {k: (v[0] if torch.is_tensor(v) else {kk: vv[0]
                                              for kk, vv in v.items()})
          for k, v in tp.items()}
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32))
    out = {}
    for impl in ("gshard", "gather"):
        c = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                             impl=impl))
        out[impl] = moe.apply_moe(tp, x, c)
    np.testing.assert_allclose(out["gshard"][0].numpy(),
                               out["gather"][0].numpy(), atol=2e-5,
                               rtol=2e-5)
    assert float(out["gshard"][1]) == pytest.approx(float(out["gather"][1]),
                                                    rel=1e-6)


@pytest.mark.parametrize("arch", MOE_ARCHS + ["command-r-35b"])
def test_forward_and_loss_match_reference(arch):
    """Logits and the summed aux loss against the reference's float32
    forward; the loss with ``router_aux_weight`` against its ``lm_loss``
    (the reference's ``loss_fn`` always computes in bf16)."""
    jcfg, japi, jparams, cfg, api, tparams = _models(arch)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    labels[0, :3] = -1
    jl, jaux = japi.forward(jparams, jnp.asarray(tokens),
                            compute_dtype=jnp.float32, remat=False)
    tl, taux = api.forward(tparams, torch.from_numpy(tokens),
                           compute_dtype=torch.float32, remat=False)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5,
                               atol=1e-7)
    aw = jcfg.moe.router_aux_weight if jcfg.moe else 0.0
    jloss, jm = jax_tf.lm_loss(jl, jnp.asarray(labels), jaux, aw)
    tloss, tm = api.loss(tparams, {"tokens": torch.from_numpy(tokens),
                                   "labels": torch.from_numpy(labels)},
                         compute_dtype=torch.float32, remat=False)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    if cfg.moe is not None:
        assert float(taux) > 0
        np.testing.assert_allclose(float(tm["moe_aux"]), float(jm["moe_aux"]),
                                   rtol=1e-5)


@pytest.mark.parametrize("arch", MOE_ARCHS + ["command-r-35b"])
def test_decode_matches_forward(arch):
    """16 ``decode_step``s (B groups of 1) reproduce the port's and the
    reference's forward logits at ``capacity_factor=8.0`` (no drops)."""
    cf = 8.0 if get_config(arch).moe else None
    jcfg, japi, jparams, cfg, api, tparams = _models(arch, cf)
    B, S = 2, 16
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    fwd, _ = api.forward(tparams, torch.from_numpy(tokens),
                         compute_dtype=torch.float32, remat=False)
    jfwd, _ = japi.forward(jparams, jnp.asarray(tokens),
                           compute_dtype=jnp.float32, remat=False)
    cache = api.init_cache(B, S, dtype=torch.float32, device="cpu")
    dec = []
    for t in range(S):
        logits, cache = api.decode_step(tparams, cache,
                                        torch.from_numpy(tokens[:, t:t + 1]))
        dec.append(logits[:, 0].numpy())
    dec = np.stack(dec, 1)
    np.testing.assert_allclose(dec, fwd.numpy(), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(dec, np.asarray(jfwd), atol=ATOL, rtol=RTOL)


def _mixed_batch(cfg, seed):
    """One mixed batch over pools holding earlier context (a 9-token
    prefill, a decode, a 3-token draft-style segment, a 6-token chunk) as
    a flat stream padded to its pow2 bucket and as a rectangle of C = 16
    rows a lane."""
    from repro_torch.serving.batch import build_tile_map
    bs, max_blocks, tile, C = 4, 8, 4, 16
    segments = [(0, 9), (7, 1), (12, 3), (3, 6)]
    n_lanes = len(segments)
    nb = n_lanes * max_blocks + 1
    rng = np.random.default_rng(seed)
    tables = np.zeros((n_lanes, max_blocks), np.int32)
    free = list(rng.permutation(np.arange(1, nb)))
    tokens, pos, slots, lanes_t = [], [], [], []
    offs, lens, lanes, pos0 = [], [], [], []
    rect = np.zeros((n_lanes, C), np.int32)
    for lane, (start, n) in enumerate(segments):
        for j in range(-(-(start + n) // bs)):
            tables[lane, j] = free.pop(0)
        offs.append(len(tokens)); lens.append(n); lanes.append(lane)
        pos0.append(start)
        toks = rng.integers(0, cfg.vocab_size, n)
        rect[lane, :n] = toks
        for i, p in enumerate(range(start, start + n)):
            tokens.append(int(toks[i]))
            pos.append(p)
            lanes_t.append(lane)
            slots.append(tables[lane, p // bs] * bs + p % bs)
    T = len(tokens)
    pad = (1 << (T - 1).bit_length()) - T
    tm = build_tile_map(offs, lens, lanes, pos0, T + pad, n_lanes, tile)
    L, Hkv, D = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    pools = {k: rng.standard_normal((L, nb, bs, Hkv, D)).astype(np.float32)
             for k in ("k", "v")}
    flat = {"block_tables": tables,
            "token_pos": np.array(pos + [0] * pad, np.int32),
            "token_lane": np.array(lanes_t + [0] * pad, np.int32),
            "slot_mapping": np.array(slots + [0] * pad, np.int32)}
    metas = {"tiled": dict(flat, tile_meta=tm.meta, row_tile=tm.row_tile),
             "per_token": flat,
             "rectangular": {"block_tables": tables,
                             "pos": np.array(pos0, np.int32),
                             "q_lens": np.array(lens, np.int32)}}
    return (np.array(tokens + [0] * pad, np.int32), rect, pools, metas, T,
            lens, tile, nb, bs, max_blocks)


@pytest.mark.parametrize("kind", ["tiled", "per_token", "rectangular"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serving_steps_match_reference(arch, kind):
    """One mixed batch through ``ragged_step`` (segment-tiled or
    per-token; the whole padded stream one capacity group) or
    ``paged_step`` (a group a lane, padding rows included), at the
    published capacity factor: the real rows' logits and the K/V written
    agree with the reference's plain step.  The reference keeps its dense
    head blocks' pools apart (``cache["head"]``); the port's head block i
    is pool layer i."""
    jcfg, japi, jparams, cfg, api, tparams = _models(arch)
    (flat_tokens, rect, pools, metas, T, lens, tile, nb, bs,
     mb) = _mixed_batch(cfg, 6)
    meta = metas[kind]
    n_lanes = meta["block_tables"].shape[0]
    n_head = cfg.moe.first_dense_layers
    jcache = jax_tf.init_paged_cache(jcfg, n_lanes, num_blocks=nb,
                                     block_size=bs, max_blocks_per_lane=mb,
                                     dtype=jnp.float32)
    jcache["scan"] = {k: jnp.asarray(v[n_head:]) for k, v in pools.items()}
    if n_head:
        jcache["head"] = {k: jnp.asarray(v[:n_head])
                          for k, v in pools.items()}
    jcache.update({k: jnp.asarray(v) for k, v in meta.items()})
    tcache = api.init_paged_cache(n_lanes, num_blocks=nb, block_size=bs,
                                  max_blocks_per_lane=mb,
                                  dtype=torch.float32, device="cpu")
    for k, v in pools.items():
        tcache["scan"][k].copy_(torch.from_numpy(v))
    tcache.update({k: torch.from_numpy(v) for k, v in meta.items()})
    if kind == "rectangular":
        jl, jnew = jax_tf.paged_step(jparams, jcache, jnp.asarray(rect),
                                     jcfg, compute_dtype=jnp.float32,
                                     use_kernel=False)
        tl, tnew = api.paged_step(tparams, tcache, torch.from_numpy(rect))
        for lane, n in enumerate(lens):
            np.testing.assert_allclose(tl[lane, :n].numpy(),
                                       np.asarray(jl)[lane, :n], atol=ATOL,
                                       rtol=RTOL)
    else:
        jcache.pop("pos")
        kw = {"tile": tile} if kind == "tiled" else {}
        jl, jnew = jax_tf.ragged_step(jparams, jcache,
                                      jnp.asarray(flat_tokens), jcfg,
                                      compute_dtype=jnp.float32,
                                      use_kernel=False, **kw)
        tl, tnew = api.ragged_step(tparams, tcache,
                                   torch.from_numpy(flat_tokens), **kw)
        np.testing.assert_allclose(tl[:T].numpy(), np.asarray(jl)[:T],
                                   atol=ATOL, rtol=RTOL)
    # padding rows all write the null block 0, in no defined order
    for k in ("k", "v"):
        want = np.asarray(jnew["scan"][k])
        if n_head:
            want = np.concatenate([np.asarray(jnew["head"][k]), want])
        np.testing.assert_allclose(tnew["scan"][k].numpy()[:, 1:],
                                   want[:, 1:], atol=ATOL, rtol=RTOL)


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


class _DropCounter:
    """Counts the (token, choice) pairs the port's MoE layers drop past
    capacity, by wrapping ``moe._route`` for the test's duration."""

    def __init__(self, monkeypatch):
        self.dropped = 0
        inner = moe._route

        def route(logits, mo, C):
            out = inner(logits, mo, C)
            self.dropped += int(out[2].sum().item() - out[4].sum().item())
            return out

        monkeypatch.setattr(moe, "_route", route)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_paged_engine_matches_reference_engine(layout, monkeypatch):
    """deepseek-moe-16b at its published capacity factor, where tokens are
    dropped: the port's paged engine emits the reference paged engine's
    greedy tokens with the same layout flags (the stream's bucket padding
    and the rectangle's padding rows take capacity slots in both)."""
    jcfg, japi, jparams, cfg, api, tparams = _models("deepseek-moe-16b")
    prompts = _prompts(cfg.vocab_size, 3, 4, 12, seed=7, shared=8)
    kw = dict(n_slots=3, cache_len=64, **LAYOUTS[layout])
    ref = _drain(JaxPagedEngine(japi, jparams, cache_dtype=jnp.float32,
                                compute_dtype=jnp.float32, **kw),
                 prompts, 10)
    drops = _DropCounter(monkeypatch)
    eng = PagedDecodeEngine(api, tparams, **PORT, **kw)
    assert _drain(eng, prompts, 10) == ref
    assert drops.dropped > 0
    assert eng.stats()["spec_verifications"] > 0


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_paged_engine_matches_slot_engine_without_drops(layout):
    """At ``capacity_factor=8.0`` no token is dropped, so routes do not
    depend on the batch: the paged engine (shared prefix, copy-on-write,
    drafts) is token-identical to the dense slot engine."""
    _, _, _, cfg, api, tparams = _models("deepseek-moe-16b", 8.0)
    rng = np.random.default_rng(3)
    shared = rng.integers(0, cfg.vocab_size, 8).astype(np.int32)
    prompts = [shared, shared.copy()] + [
        np.concatenate([shared, p]) for p in _prompts(
            cfg.vocab_size, 3, 2, 7, seed=4)]
    kw = dict(n_slots=3, cache_len=64, **PORT)
    paged = PagedDecodeEngine(api, tparams, block_size=4, chunk_tokens=8,
                              **LAYOUTS[layout], **kw)
    slot = SlotDecodeEngine(api, tparams, **kw)
    paged.submit(prompts[0], 8)
    paged.step()
    paged.step()                 # the preamble's blocks are registered
    got = _drain(paged, prompts[1:], 8)
    got.update({r.request_id: list(r.generated)
                for r in paged.take_finished()})
    assert got == _drain(slot, prompts, 8)
    assert paged.kv.cow_copies > 0 and paged.kv.prefix_hits > 0


def test_command_r_engine_matches_reference_engine():
    """command-r-35b (parallel block, layernorm, tied vocab, G 8 at full
    width) serves the reference engine's tokens in the default layout."""
    jcfg, japi, jparams, cfg, api, tparams = _models("command-r-35b")
    prompts = _prompts(cfg.vocab_size, 3, 4, 12, seed=11, shared=8)
    kw = dict(n_slots=3, cache_len=64)
    ref = _drain(JaxPagedEngine(japi, jparams, cache_dtype=jnp.float32,
                                compute_dtype=jnp.float32, **kw),
                 prompts, 10)
    eng = PagedDecodeEngine(api, tparams, **PORT, **kw)
    assert _drain(eng, prompts, 10) == ref
    assert eng.stats()["spec_verifications"] > 0
