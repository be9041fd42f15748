"""The port's dense transformer against the reference's, in float32 on the
CPU: parameters converted from the reference's ``init``, inputs made with
numpy from a seed, logits compared with ``allclose``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import transformer as jax_tf
from repro_torch.configs import get_config
from repro_torch.models import transformer as tf
from repro_torch.models.api import build_model
from repro_torch.models.convert import from_reference_params
from repro_torch.serving.batch import build_tile_map

# two float32 stacks of 2 layers (d_model 256) contracting in different
# orders: logits agree to a few 1e-5
ATOL = RTOL = 1e-4
ARCHS = ["gemma-7b", "starcoder2-7b"]


def _models(arch):
    jcfg = jax_get_config(arch).smoke_variant()
    cfg = get_config(arch).smoke_variant()
    japi = jax_build_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    tparams = from_reference_params(jax.tree.map(np.asarray, jparams),
                                    device="cpu", dtype=torch.float32)
    return jcfg, japi, jparams, cfg, build_model(cfg), tparams


def test_configs_match_reference():
    """The port's config copies equal the reference's, full and smoke."""
    for arch in ARCHS:
        for smoke in (False, True):
            j = jax_get_config(arch)
            t = get_config(arch)
            if smoke:
                j, t = j.smoke_variant(), t.smoke_variant()
            for f in j.__dataclass_fields__:
                assert getattr(t, f) == getattr(j, f), (arch, smoke, f)


def test_init_params_shapes_match_reference():
    """The port's own init makes the reference's tree: same keys and
    shapes, weights in the compute dtype, norms in float32."""
    for arch in ARCHS:
        jcfg = jax_get_config(arch).smoke_variant()
        jtree = jax.eval_shape(lambda: jax_build_model(jcfg).init(
            jax.random.PRNGKey(0)))
        tparams = build_model(get_config(arch).smoke_variant()).init(
            seed=0, device="cpu", dtype=torch.bfloat16)
        jflat = {jax.tree_util.keystr(k): v.shape for k, v in
                 jax.tree_util.tree_flatten_with_path(jtree)[0]}
        tflat = {jax.tree_util.keystr(k): v for k, v in
                 jax.tree_util.tree_flatten_with_path(tparams)[0]}
        assert set(jflat) == set(tflat), arch
        for k, shape in jflat.items():
            assert tuple(tflat[k].shape) == tuple(shape), (arch, k)
            want = torch.float32 if "norm" in k else torch.bfloat16
            assert tflat[k].dtype == want, (arch, k)
        emb = tflat["['embed']['embedding']"].float()
        assert abs(emb.std().item() - 0.02) < 2e-3


def _mixed_stream(cfg, seed, window):
    """One ragged step's worth of metadata over pools that already hold
    earlier context: a fresh prefill straddling tile windows, a decode,
    a 3-token draft-style segment and, for a window arch, a segment past
    the window."""
    bs, max_blocks, tile = 4, 24, 4
    segments = [(0, 9), (7, 1), (12, 3)]
    if window:
        segments.append((window + 6, 2))
    n_lanes = len(segments)
    num_blocks = n_lanes * max_blocks + 1
    rng = np.random.default_rng(seed)
    tables = np.zeros((n_lanes, max_blocks), np.int32)
    free = list(rng.permutation(np.arange(1, num_blocks)))
    tokens, pos, slots, tok_lane = [], [], [], []
    offs, lens, lanes, pos0 = [], [], [], []
    for lane, (start, n) in enumerate(segments):
        for j in range(-(-(start + n) // bs)):
            tables[lane, j] = free.pop(0)
        offs.append(len(tokens)); lens.append(n); lanes.append(lane)
        pos0.append(start)
        for p in range(start, start + n):
            tokens.append(int(rng.integers(0, cfg.vocab_size)))
            pos.append(p)
            tok_lane.append(lane)
            slots.append(tables[lane, p // bs] * bs + p % bs)
    T = len(tokens)
    T_pad = 1 << (T - 1).bit_length()
    pad = T_pad - T
    tm = build_tile_map(offs, lens, lanes, pos0, T_pad, n_lanes, tile)
    L, Hkv, D = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    pools = {name: rng.standard_normal((L, num_blocks, bs, Hkv, D))
             .astype(np.float32) for name in ("k", "v")}
    meta = {"block_tables": tables,
            "token_pos": np.array(pos + [0] * pad, np.int32),
            "token_lane": np.array(tok_lane + [0] * pad, np.int32),
            "slot_mapping": np.array(slots + [0] * pad, np.int32),
            "tile_meta": tm.meta, "row_tile": tm.row_tile}
    return (np.array(tokens + [0] * pad, np.int32), pools, meta, T, tile,
            num_blocks, bs, max_blocks)


def _check_ragged_step(arch, tiled):
    """One mixed ragged step through the segment-tiled read (``tiled``)
    or the per-token read (no TileMap in the cache, ``token_lane``
    instead): logits on real rows and the written pools agree with the
    reference's plain (``use_kernel=False``) step given the same
    metadata."""
    jcfg, japi, jparams, cfg, api, tparams = _models(arch)
    window = api.effective_window(128)
    tokens, pools, meta, T, tile, nb, bs, mb = _mixed_stream(cfg, 3, window)
    if not tiled:
        del meta["tile_meta"], meta["row_tile"]
    n_lanes = meta["block_tables"].shape[0]
    jcache = jax_tf.init_paged_cache(jcfg, n_lanes, num_blocks=nb,
                                     block_size=bs, max_blocks_per_lane=mb,
                                     dtype=jnp.float32)
    jcache.pop("pos")
    jcache["scan"] = {k: jnp.asarray(v) for k, v in pools.items()}
    jcache.update({k: jnp.asarray(v) for k, v in meta.items()})
    jlogits, jnew = jax_tf.ragged_step(jparams, jcache, jnp.asarray(tokens),
                                       jcfg, window=window, tile=tile,
                                       compute_dtype=jnp.float32,
                                       use_kernel=False)
    tcache = api.init_paged_cache(n_lanes, num_blocks=nb, block_size=bs,
                                  max_blocks_per_lane=mb,
                                  dtype=torch.float32, device="cpu")
    for k, v in pools.items():
        tcache["scan"][k].copy_(torch.from_numpy(v))
    tcache.update({k: torch.from_numpy(v) for k, v in meta.items()})
    tlogits, tnew = api.ragged_step(tparams, tcache,
                                    torch.from_numpy(tokens), window=window,
                                    tile=tile)
    assert tlogits.shape == (len(tokens), cfg.vocab_size)
    np.testing.assert_allclose(tlogits[:T].numpy(), np.asarray(jlogits)[:T],
                               atol=ATOL, rtol=RTOL)
    _assert_pools_close(tnew, jnew, pools, meta["slot_mapping"][:T], cfg)


def _assert_pools_close(tcache, jcache, pools, slots, cfg):
    """The K/V written at physical ``slots`` agree between the packages."""
    real = np.asarray(slots)
    for k in ("k", "v"):
        got = tcache["scan"][k].numpy().reshape(cfg.n_layers, -1,
                                                *pools[k].shape[3:])
        want = np.asarray(jcache["scan"][k]).reshape(got.shape)
        np.testing.assert_allclose(got[:, real], want[:, real], atol=ATOL,
                                   rtol=RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_ragged_step_matches_reference(arch):
    """The segment-tiled ragged step against the reference's."""
    _check_ragged_step(arch, tiled=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_per_token_ragged_step_matches_reference(arch):
    """The per-token ragged step (``tiled=False``: the attention read
    gathers ``block_tables[token_lane]``) against the reference's."""
    _check_ragged_step(arch, tiled=False)


def _rect_chunk(cfg, seed, window):
    """One rectangular step's batch over pools holding earlier context:
    lanes (start, q_len) padded to C = 16 -- a fresh 9-token prefill, a
    decode, a 3-token draft-style chunk, a paused lane (q_len 0, whose
    writes must go to the null block) and, for a window arch, a chunk
    past the window."""
    bs, max_blocks, C = 4, 24, 16
    segments = [(0, 9), (7, 1), (12, 3), (5, 0)]
    if window:
        segments.append((window + 6, 2))
    n_lanes = len(segments)
    num_blocks = n_lanes * max_blocks + 1
    rng = np.random.default_rng(seed)
    tables = np.zeros((n_lanes, max_blocks), np.int32)
    free = list(rng.permutation(np.arange(1, num_blocks)))
    tokens = np.zeros((n_lanes, C), np.int32)
    slots = []
    for lane, (start, n) in enumerate(segments):
        for j in range(-(-(start + n) // bs)):
            tables[lane, j] = free.pop(0)
        tokens[lane, :n] = rng.integers(0, cfg.vocab_size, n)
        slots += [tables[lane, p // bs] * bs + p % bs
                  for p in range(start, start + n)]
    L, Hkv, D = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    pools = {name: rng.standard_normal((L, num_blocks, bs, Hkv, D))
             .astype(np.float32) for name in ("k", "v")}
    meta = {"block_tables": tables,
            "pos": np.array([s for s, _ in segments], np.int32),
            "q_lens": np.array([n for _, n in segments], np.int32)}
    return tokens, pools, meta, slots, num_blocks, bs, max_blocks


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_step_matches_reference(arch):
    """One rectangular ``paged_step``: logits on every lane's real rows,
    the K/V written at real slots and the advanced ``pos`` agree with the
    reference's plain step; the paused lane's chunk writes nothing but
    the null block."""
    jcfg, japi, jparams, cfg, api, tparams = _models(arch)
    window = api.effective_window(128)
    tokens, pools, meta, slots, nb, bs, mb = _rect_chunk(cfg, 5, window)
    n_lanes = tokens.shape[0]
    jcache = jax_tf.init_paged_cache(jcfg, n_lanes, num_blocks=nb,
                                     block_size=bs, max_blocks_per_lane=mb,
                                     dtype=jnp.float32)
    jcache["scan"] = {k: jnp.asarray(v) for k, v in pools.items()}
    jcache.update({k: jnp.asarray(v) for k, v in meta.items()})
    jlogits, jnew = jax_tf.paged_step(jparams, jcache, jnp.asarray(tokens),
                                      jcfg, window=window,
                                      compute_dtype=jnp.float32,
                                      use_kernel=False)
    tcache = api.init_paged_cache(n_lanes, num_blocks=nb, block_size=bs,
                                  max_blocks_per_lane=mb,
                                  dtype=torch.float32, device="cpu")
    for k, v in pools.items():
        tcache["scan"][k].copy_(torch.from_numpy(v))
    tcache.update({k: torch.from_numpy(v) for k, v in meta.items()})
    tlogits, tnew = api.paged_step(tparams, tcache,
                                   torch.from_numpy(tokens), window=window)
    assert tlogits.shape == tokens.shape + (cfg.vocab_size,)
    jl = np.asarray(jlogits)
    for lane, n in enumerate(meta["q_lens"]):
        np.testing.assert_allclose(tlogits[lane, :n].numpy(), jl[lane, :n],
                                   atol=ATOL, rtol=RTOL)
    _assert_pools_close(tnew, jnew, pools, slots, cfg)
    np.testing.assert_array_equal(tnew["pos"].numpy(), np.asarray(jnew["pos"]))
    untouched = np.ones(nb * bs, bool)
    untouched[np.asarray(slots)] = False
    untouched[0] = False                    # the null block's write target
    for k in ("k", "v"):
        got = tnew["scan"][k].numpy().reshape(cfg.n_layers, nb * bs, -1)
        np.testing.assert_array_equal(
            got[:, untouched],
            pools[k].reshape(cfg.n_layers, nb * bs, -1)[:, untouched])

    # the q_len = 1 step without q_lens (every lane real), from the
    # advanced positions
    jcache = dict(jnew)
    jcache.pop("q_lens")
    tnew.pop("q_lens")
    dec = tokens[:, :1]
    jl, _ = jax_tf.paged_decode_step(jparams, jcache, jnp.asarray(dec), jcfg,
                                     window=window,
                                     compute_dtype=jnp.float32)
    tl, tdec = api.paged_decode_step(tparams, tnew, torch.from_numpy(dec),
                                     window=window)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_array_equal(tdec["pos"].numpy(),
                                  np.asarray(jnew["pos"]) + 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(arch):
    """The dense-slot decode step, token by token past the smoke
    window's 64-slot rolling buffer for starcoder2."""
    jcfg, japi, jparams, cfg, api, tparams = _models(arch)
    window = api.effective_window(128)
    B, n_steps = 2, 70 if window else 12
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (n_steps, B, 1)).astype(np.int32)
    jcache = japi.init_cache(B, 128, window=window, dtype=jnp.float32)
    tcache = api.init_cache(B, 128, window=window, dtype=torch.float32,
                            device="cpu")
    step = jax.jit(lambda p, c, t: japi.decode_step(
        p, c, t, window=window, compute_dtype=jnp.float32))
    for i in range(n_steps):
        jl, jcache = step(jparams, jcache, jnp.asarray(toks[i]))
        tl, tcache = api.decode_step(tparams, tcache,
                                     torch.from_numpy(toks[i]),
                                     window=window)
        if i % 10 == 9 or i == n_steps - 1:
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       atol=ATOL, rtol=RTOL)
    assert int(tcache["pos"][0]) == n_steps


def test_quantize_kv_and_int8_write_match_reference():
    """int8 quantization and the int8 pool scatter equal the reference's
    bit for bit (same float32 arithmetic, round-half-even)."""
    rng = np.random.default_rng(11)
    nb, bs, Hkv, D, T = 6, 4, 2, 64, 9
    k = (rng.standard_normal((T, Hkv, D)) * 3).astype(np.float32)
    v = (rng.standard_normal((T, Hkv, D)) * 3).astype(np.float32)
    jq, js = jax_tf._quantize_kv(jnp.asarray(k))
    tq, ts = tf._quantize_kv(torch.from_numpy(k))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    blk = rng.integers(1, nb, T).astype(np.int32)
    off = rng.permutation(nb * bs)[:T] % bs
    off = off.astype(np.int32)
    # distinct (blk, off) pairs so the scatter order cannot matter
    pairs = sorted({(int(b), int(o)) for b, o in zip(blk, off)})
    blk = np.array([p[0] for p in pairs], np.int32)
    off = np.array([p[1] for p in pairs], np.int32)
    k, v = k[:len(pairs)], v[:len(pairs)]
    pools = {"k": np.zeros((nb, bs, Hkv, D), np.int8),
             "v": np.zeros((nb, bs, Hkv, D), np.int8),
             "k_scale": np.zeros((nb, bs, Hkv), np.float32),
             "v_scale": np.zeros((nb, bs, Hkv), np.float32)}
    jnew = jax_tf._write_kv_pool({n: jnp.asarray(a) for n, a in pools.items()},
                                 jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(blk), jnp.asarray(off))
    tpools = {n: torch.from_numpy(a.copy()) for n, a in pools.items()}
    tf._write_kv_pool(tpools, torch.from_numpy(k), torch.from_numpy(v),
                      torch.from_numpy(blk).long(),
                      torch.from_numpy(off).long())
    for n in pools:
        np.testing.assert_array_equal(tpools[n].numpy(),
                                      np.asarray(jnew[n]))
