"""The port's paged attention (segment-tiled, per-token and rectangular
reads) against the reference's.

Inputs are made with numpy from a seed and fed to both packages: the
port's plain versions (``repro_torch.kernels.ref``) are held to the
reference's Pallas kernels in interpret mode and to the reference's jnp
oracles, on real rows only, with ``allclose`` at float32 tolerance (the
two oracles differ at rounding level between themselves, so exact
equality is never asked).  The CUDA kernels themselves are held to the
plain versions on the card; those cases are marked ``cuda`` and skip
where there is no card.  The bf16 per-token and rectangular reads run a
tensor-core split sweep on the card; its host-side split planner and its
arithmetic (split partials merged, softmax weights rounded to bf16 with
an int8 pool's v_scale folded in) are checked here, in plain PyTorch,
against the reference's oracle.  The JAX side is imported by the tests
that use it, so that the CUDA cases also run on a machine that has no
JAX:

    python -m pytest -q --noconftest -m cuda tests/test_torch_paged_attention.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import ref as tref
from repro_torch.serving.batch import build_tile_map

# float32 agreement between the two frameworks' contractions: both sum
# D = 32 products in float32 in different orders
ATOL = RTOL = 2e-5

# (tile, segments, T_pad), each segment (start_pos, n_tokens) of one lane,
# the mixes of tests/test_kernels_paged_attention.py: windows straddling
# segment boundaries, segments smaller and larger than a tile, decodes,
# start positions straddling block edges (bs = 4)
TILED_MIXES = {
    "straddling_boundaries": (4, [(3, 1), (0, 9), (7, 5), (14, 1)], 16),
    "segments_smaller_than_tile": (16, [(0, 3), (1, 2), (4, 6)], 16),
    "segments_larger_than_tile": (4, [(0, 17), (5, 9)], 32),
    "all_decode": (8, [(2, 1), (5, 1), (9, 1), (0, 1)], 8),
}
# the per-token mixes of tests/test_kernels_paged_attention.py
# (SEGMENT_MIXES): all decodes, one prefill among decodes, several
# prefills, with starts straddling block edges; the stream is padded to a
# power of two with null-table, position-0 tokens, as the engine pads it
SEGMENT_MIXES = {
    "all_decode": [(4, 1), (9, 1), (0, 1), (14, 1)],
    "one_prefill_plus_decodes": [(3, 1), (0, 9), (7, 1)],
    "multi_prefill": [(2, 6), (0, 5), (5, 7)],
}
# rectangular cases, each (C, q_starts, q_lens) per lane: that file's
# chunk case (fresh, mid-block and deep lanes, full and padded chunks),
# one with a paused lane (q_len 0 past its context) and an empty lane
# (q_len 0, context 0), and its decode case (C = 1 at ctx - 1)
CHUNK_CASES = {
    "chunk": (5, [0, 3, 9], [5, 4, 2]),
    "chunk_paused_and_empty_lanes": (4, [6, 4, 0], [3, 0, 0]),
    "decode": (1, [0, 8, 25], [1, 1, 1]),
}
HKV, D, BS, MAX_BLOCKS = 2, 32, 4, 8


@pytest.fixture
def jax_side():
    """The reference package's kernels, oracles and tile-map builder."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import paged_attention as jpa
    from repro.kernels import ref as jref
    from repro.serving.batch import build_tile_map as jax_build_tile_map
    return dict(jnp=jnp, kernel=jpa.paged_attention_ragged_tiled,
                ref=jref.paged_attention_ragged_tiled_reference,
                build_tile_map=jax_build_tile_map, pa=jpa, oracles=jref)


def _pools(rng, num_blocks, quantized, dim):
    """K/V pools (num_blocks, BS, HKV, dim) and, for int8, their scales."""
    shape = (num_blocks, BS, HKV, dim)
    if quantized:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(0.002, 0.02, shape[:3]).astype(np.float32)
        vs = rng.uniform(0.002, 0.02, shape[:3]).astype(np.float32)
        return k, v, ks, vs
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    return k, v, None, None


def _lane_tables(ends, max_blocks=MAX_BLOCKS):
    """Disjoint block-table rows covering each lane's first ``end``
    positions, from block 1 up; unused entries point at the null block
    0."""
    tables = np.zeros((len(ends), max_blocks), np.int32)
    free = 1
    for lane, end in enumerate(ends):
        for j in range(-(-int(end) // BS)):
            tables[lane, j] = free
            free += 1
    return tables


def _setup(mix, G, quantized, seed=0, jax_side=None, dim=D):
    """numpy inputs: q (T_pad, H, D), pools, scales, per-lane tables and
    the tile map (the reference's and the port's builders must agree)."""
    tile, segments, T_pad = TILED_MIXES[mix]
    rng = np.random.default_rng(seed)
    n_lanes = len(segments)
    num_blocks = n_lanes * MAX_BLOCKS + 1
    H = HKV * G
    q = rng.standard_normal((T_pad, H, dim)).astype(np.float32)
    k, v, ks, vs = _pools(rng, num_blocks, quantized, dim)
    tables = _lane_tables([start + n for start, n in segments])
    offs, lens, lanes, pos0 = [], [], [], []
    off = 0
    for lane, (start, n) in enumerate(segments):
        offs.append(off); lens.append(n); lanes.append(lane)
        pos0.append(start)
        off += n
    tm = build_tile_map(offs, lens, lanes, pos0, T_pad, n_lanes, tile)
    if jax_side is not None:
        ref_tm = jax_side["build_tile_map"](offs, lens, lanes, pos0, T_pad,
                                            n_lanes, tile)
        np.testing.assert_array_equal(tm.meta, ref_tm.meta)
        np.testing.assert_array_equal(tm.row_tile, ref_tm.row_tile)
    return dict(q=q, k=k, v=v, ks=ks, vs=vs, tables=tables, meta=tm.meta,
                row_tile=tm.row_tile, tile=tile, T=off)


def _t(a, device="cpu"):
    """A numpy input as a tensor on ``device`` (None stays None)."""
    return None if a is None else torch.from_numpy(a).to(device)


def _torch_args(d, device="cpu"):
    return {name: _t(d[name], device)
            for name in ("q", "k", "v", "ks", "vs", "tables", "meta",
                         "row_tile")}


def _port_ref(d, window):
    t = _torch_args(d)
    return tref.paged_attention_ragged_tiled_reference(
        t["q"], t["k"], t["v"], t["tables"], t["meta"], t["row_tile"],
        tile=d["tile"], window=window, k_scale=t["ks"],
        v_scale=t["vs"]).numpy()


def _jax_scales(jnp, d):
    if d["ks"] is None:
        return {}
    return {"k_scale": jnp.asarray(d["ks"]), "v_scale": jnp.asarray(d["vs"])}


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("mix", sorted(TILED_MIXES))
def test_port_reference_matches_reference_kernel_and_oracle(jax_side, mix, G,
                                                            window,
                                                            quantized):
    """Port plain version vs the reference's Pallas kernel (interpret
    mode) and vs the reference's jnp oracle, on every real row."""
    jnp = jax_side["jnp"]
    d = _setup(mix, G, quantized, jax_side=jax_side)
    T, tile = d["T"], d["tile"]
    T_pad, H, _ = d["q"].shape
    got = _port_ref(d, window)
    assert got.shape == (T_pad, H, D) and got.dtype == np.float32
    assert np.all(np.isfinite(got))
    oracle = np.asarray(jax_side["ref"](
        jnp.asarray(d["q"]), jnp.asarray(d["k"]), jnp.asarray(d["v"]),
        jnp.asarray(d["tables"]), jnp.asarray(d["meta"]),
        jnp.asarray(d["row_tile"]), tile=tile, window=window,
        **_jax_scales(jnp, d)))
    np.testing.assert_allclose(got[:T], oracle[:T], atol=ATOL, rtol=RTOL)
    kern = np.asarray(jax_side["kernel"](
        jnp.asarray(d["q"].reshape(T_pad, HKV, G, D)), jnp.asarray(d["k"]),
        jnp.asarray(d["v"]), jnp.asarray(d["tables"]),
        jnp.asarray(d["meta"]), jnp.asarray(d["row_tile"]), tile=tile,
        window=window, interpret=True, **_jax_scales(jnp, d)))
    np.testing.assert_allclose(got[:T], kern.reshape(T_pad, H, D)[:T],
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_ops_dispatch_by_device(quantized):
    """CPU tensors take the plain version under ``use_kernel=None`` (and
    the kernel wrapper itself falls back to it only for CPU tensors);
    ``use_kernel=True`` on CPU tensors raises."""
    d = _setup("straddling_boundaries", 2, quantized)
    t = _torch_args(d)
    args = (t["q"], t["k"], t["v"], t["tables"], t["meta"], t["row_tile"])
    kw = dict(tile=d["tile"], window=5, k_scale=t["ks"], v_scale=t["vs"])
    want = tref.paged_attention_ragged_tiled_reference(*args, **kw)
    got = ops.paged_attention_ragged_tiled(*args, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    before = dict(tpa.launch_counts)
    T, H, _ = t["q"].shape
    wrapped = tpa.paged_attention_ragged_tiled(
        t["q"].reshape(T, HKV, H // HKV, D), *args[1:], **kw)
    torch.testing.assert_close(wrapped.reshape(T, H, D), want, rtol=0,
                               atol=0)
    assert tpa.launch_counts == before     # the CPU path launches nothing
    with pytest.raises(ValueError, match="use_kernel=True"):
        ops.paged_attention_ragged_tiled(*args, use_kernel=True, **kw)


@pytest.fixture
def cuda_device():
    """The first CUDA card; skips where there is none (the kernel has no
    CPU or interpret mode)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel runs only there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["f32", "bf16", "int8", "int8_bf16q"])
def test_cuda_kernel_matches_plain_version(cuda_device, pool):
    """The segment-tiled Hopper kernels against their plain version on the
    card, every TILED_MIXES case, G in {1, 4}, window in {0, 5}, head dim
    64 (the kernels are built for 64, 128 and 256): float32 q (f32 and
    int8 pools) on the FMA kernel, bf16 q (bf16 pools, and int8 pools
    under "int8_bf16q") on the split sweep, which also runs every mix at
    G 9 (tiles of up to 144 rows, 9 items each) and head dims 128 and 256,
    and returns the same bits twice.  Each call counts one launch."""
    tc = pool in ("bf16", "int8_bf16q")
    # bf16: the plain version rounds scores and weights to bf16, the
    # kernels keep scores in float32.  Largest readings on an H100 (the
    # test prints them): 3.1e-2 bf16, 1.6e-2 int8_bf16q, 9.5e-7 f32,
    # 8.3e-7 int8
    tol = 5e-2 if tc else 1e-4
    shapes = [(G, 64) for G in (1, 4)]
    if tc:
        shapes += [(9, 128), (9, 256)]
    before = tpa.launch_counts[tpa.TILED]
    calls, worst = 0, 0.0
    for mix in sorted(TILED_MIXES):
        for G, dim in shapes:
            for window in (0, 5):
                d = _setup(mix, G, pool.startswith("int8"), dim=dim)
                t = _torch_args(d, cuda_device)
                p = _cuda_pools(d, cuda_device, pool)
                args = (_cuda_q(d, cuda_device, pool), p["k"], p["v"],
                        t["tables"], t["meta"], t["row_tile"])
                kw = dict(tile=d["tile"], window=window, k_scale=p["ks"],
                          v_scale=p["vs"])
                want = tref.paged_attention_ragged_tiled_reference(
                    *args, **kw)
                got = ops.paged_attention_ragged_tiled(*args, **kw)
                calls += 1
                if tc:
                    again = ops.paged_attention_ragged_tiled(*args, **kw)
                    calls += 1
                torch.cuda.synchronize()
                T = d["T"]
                assert torch.isfinite(got[:T]).all()
                if tc:
                    assert torch.equal(got, again)
                worst = max(worst, (got[:T].float() - want[:T].float()
                                    ).abs().max().item())
                torch.testing.assert_close(got[:T].float(),
                                           want[:T].float(), atol=tol,
                                           rtol=tol)
    print(f"B1 {pool}: largest |kernel - plain| {worst:.2e}")
    assert tpa.launch_counts[tpa.TILED] == before + calls


# ---------------------------------------------------------------------------
# the per-token read (B2) and the rectangular read (B3)
# ---------------------------------------------------------------------------
def _ragged_setup(mix, G, quantized, seed=0, dim=D):
    """numpy inputs of the per-token read: q (T_pad, H, D), pools, scales,
    token_tables (T_pad, MAX_BLOCKS) and token_pos (T_pad,)."""
    segments = SEGMENT_MIXES[mix]
    rng = np.random.default_rng(seed)
    T = sum(n for _, n in segments)
    T_pad = 1 << (T - 1).bit_length()
    q = rng.standard_normal((T_pad, HKV * G, dim)).astype(np.float32)
    k, v, ks, vs = _pools(rng, len(segments) * MAX_BLOCKS + 1, quantized,
                          dim)
    tables = _lane_tables([s + n for s, n in segments])
    token_tables = np.zeros((T_pad, MAX_BLOCKS), np.int32)
    token_pos = np.zeros((T_pad,), np.int32)
    off = 0
    for lane, (start, n) in enumerate(segments):
        token_tables[off:off + n] = tables[lane]
        token_pos[off:off + n] = start + np.arange(n)
        off += n
    return dict(q=q, k=k, v=v, ks=ks, vs=vs, token_tables=token_tables,
                token_pos=token_pos, T=T)


def _chunk_setup(case, G, quantized, seed=0, dim=D, C=None, starts=None,
                 lens=None, max_blocks=MAX_BLOCKS):
    """numpy inputs of the rectangular read: q (B, C, H, D), pools,
    scales, block_tables (B, MAX_BLOCKS), q_starts and q_lens (B,)."""
    if case is not None:
        C, starts, lens = CHUNK_CASES[case]
    starts = np.asarray(starts, np.int32)
    lens = np.asarray(lens, np.int32)
    rng = np.random.default_rng(seed)
    B = len(starts)
    q = rng.standard_normal((B, C, HKV * G, dim)).astype(np.float32)
    k, v, ks, vs = _pools(rng, B * max_blocks + 1, quantized, dim)
    tables = _lane_tables(starts + lens, max_blocks)
    return dict(q=q, k=k, v=v, ks=ks, vs=vs, tables=tables, starts=starts,
                lens=lens)


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("mix", sorted(SEGMENT_MIXES))
def test_per_token_reference_matches_reference_kernel_and_oracle(
        jax_side, mix, G, window, quantized):
    """Port ``paged_attention_ragged_reference`` vs the reference's
    per-token Pallas kernel (interpret mode) and jnp oracle, on every real
    row of a padded stream; padding rows stay finite."""
    jnp, jpa, jref = jax_side["jnp"], jax_side["pa"], jax_side["oracles"]
    d = _ragged_setup(mix, G, quantized)
    T = d["T"]
    T_pad, H, _ = d["q"].shape
    got = tref.paged_attention_ragged_reference(
        _t(d["q"]), _t(d["k"]), _t(d["v"]), _t(d["token_tables"]),
        _t(d["token_pos"]), window=window, k_scale=_t(d["ks"]),
        v_scale=_t(d["vs"])).numpy()
    assert got.shape == (T_pad, H, D) and np.all(np.isfinite(got))
    jargs = [jnp.asarray(d[n]) for n in ("k", "v", "token_tables",
                                         "token_pos")]
    oracle = np.asarray(jref.paged_attention_ragged_reference(
        jnp.asarray(d["q"]), *jargs, window=window, **_jax_scales(jnp, d)))
    np.testing.assert_allclose(got[:T], oracle[:T], atol=ATOL, rtol=RTOL)
    kern = np.asarray(jpa.paged_attention_ragged(
        jnp.asarray(d["q"].reshape(T_pad, HKV, G, D)), *jargs,
        window=window, interpret=True, **_jax_scales(jnp, d)))
    np.testing.assert_allclose(got[:T], kern.reshape(T_pad, H, D)[:T],
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_rows_references_match_reference_kernel_and_oracle(
        jax_side, case, G, window, quantized):
    """Port ``paged_attention_chunk_reference`` (and, for C = 1,
    ``paged_attention_reference``) vs the reference's rectangular Pallas
    kernel (interpret mode, through ``paged_attention_chunk`` and
    ``paged_attention``) and its jnp oracles, on the real rows of every
    lane; padded rows stay finite."""
    jnp, jpa, jref = jax_side["jnp"], jax_side["pa"], jax_side["oracles"]
    d = _chunk_setup(case, G, quantized)
    B, C, H, _ = d["q"].shape
    starts, lens = d["starts"], d["lens"]
    sc = dict(k_scale=_t(d["ks"]), v_scale=_t(d["vs"]))
    got = tref.paged_attention_chunk_reference(
        _t(d["q"]), _t(d["k"]), _t(d["v"]), _t(d["tables"]), _t(starts),
        window=window, **sc).numpy()
    assert got.shape == (B, C, H, D) and np.all(np.isfinite(got))
    jargs = [jnp.asarray(d[n]) for n in ("k", "v", "tables")]
    oracle = np.asarray(jref.paged_attention_chunk_reference(
        jnp.asarray(d["q"]), *jargs, jnp.asarray(starts), window=window,
        **_jax_scales(jnp, d)))
    q5 = np.transpose(d["q"].reshape(B, C, HKV, G, D), (0, 2, 1, 3, 4))
    kern = np.asarray(jpa.paged_attention_chunk(
        jnp.asarray(q5), *jargs, jnp.asarray(starts),
        jnp.asarray(starts + lens), window=window, interpret=True,
        **_jax_scales(jnp, d)))
    kern = np.transpose(kern, (0, 2, 1, 3, 4)).reshape(B, C, H, D)
    for b in range(B):
        n = lens[b]
        np.testing.assert_allclose(got[b, :n], oracle[b, :n], atol=ATOL,
                                   rtol=RTOL)
        np.testing.assert_allclose(got[b, :n], kern[b, :n], atol=ATOL,
                                   rtol=RTOL)
    if C == 1:
        ctx = starts + 1
        dec = tref.paged_attention_reference(
            _t(d["q"][:, 0]), _t(d["k"]), _t(d["v"]), _t(d["tables"]),
            _t(ctx), window=window, **sc).numpy()
        np.testing.assert_array_equal(dec, got[:, 0])
        jdec = np.asarray(jref.paged_attention_reference(
            jnp.asarray(d["q"][:, 0]), *jargs, jnp.asarray(ctx),
            window=window, **_jax_scales(jnp, d)))
        np.testing.assert_allclose(dec, jdec, atol=ATOL, rtol=RTOL)
        jkern = np.asarray(jpa.paged_attention(
            jnp.asarray(d["q"][:, 0].reshape(B, HKV, G, D)), *jargs,
            jnp.asarray(ctx), window=window, interpret=True,
            **_jax_scales(jnp, d)))
        np.testing.assert_allclose(dec, jkern.reshape(B, H, D), atol=ATOL,
                                   rtol=RTOL)


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("read", ["per_token", "chunk", "decode"])
def test_ops_dispatch_by_device_per_token_and_rows(read, quantized):
    """The per-token, chunk and decode reads: CPU tensors take the plain
    version under ``use_kernel=None`` (the kernel wrappers too, without a
    launch); ``use_kernel=True`` on CPU tensors raises."""
    if read == "per_token":
        d = _ragged_setup("one_prefill_plus_decodes", 2, quantized)
        q = _t(d["q"])
        meta = (_t(d["token_tables"]), _t(d["token_pos"]))
        op, plain = ops.paged_attention_ragged, \
            tref.paged_attention_ragged_reference
        wrapper, shape = tpa.paged_attention_ragged, q.shape[:1]
    else:
        d = _chunk_setup("chunk" if read == "chunk" else "decode", 2,
                         quantized)
        q = _t(d["q"])
        tables, starts = _t(d["tables"]), _t(d["starts"])
        if read == "chunk":
            meta = (tables, starts)
            op = lambda *a, **k: ops.paged_attention_chunk(
                *a, _t(d["lens"]), **k)
            plain = tref.paged_attention_chunk_reference
            wrapper = lambda q4, *a, **k: tpa.paged_attention_chunk(
                q4, *a, starts + _t(d["lens"]), **k)
            shape = q.shape[:2]
        else:
            q = q[:, 0]
            meta = (tables, starts + 1)
            op, plain = ops.paged_attention, tref.paged_attention_reference
            wrapper, shape = tpa.paged_attention, q.shape[:1]
    args = (q, _t(d["k"]), _t(d["v"])) + meta
    kw = dict(window=5, k_scale=_t(d["ks"]), v_scale=_t(d["vs"]))
    want = plain(*args, **kw)
    torch.testing.assert_close(op(*args, **kw), want, rtol=0, atol=0)
    before = dict(tpa.launch_counts)
    H, Dq = q.shape[-2:]
    wrapped = wrapper(q.reshape(*shape, HKV, H // HKV, Dq), *args[1:], **kw)
    torch.testing.assert_close(wrapped.reshape(want.shape), want, rtol=0,
                               atol=0)
    assert tpa.launch_counts == before
    with pytest.raises(ValueError, match="use_kernel=True"):
        op(*args, use_kernel=True, **kw)


def _cuda_pools(d, device, pool):
    t = {n: _t(d[n], device) for n in ("k", "v", "ks", "vs")}
    if pool == "bf16":
        t["k"], t["v"] = t["k"].bfloat16(), t["v"].bfloat16()
    return t


def _cuda_q(d, device, pool):
    """q on the card: bf16 for the tensor-core reads (bf16 pools, and int8
    pools under "int8_bf16q"), float32 for the FMA ones."""
    q = _t(d["q"], device)
    return q.bfloat16() if pool in ("bf16", "int8_bf16q") else q


# ---------------------------------------------------------------------------
# the split sweep of the bf16 reads: its planner and its arithmetic
# ---------------------------------------------------------------------------
def _bf16v(a):
    """numpy float32 values rounded to bf16 (kept as float32)."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float()


def _sweep_emulation(q_rows, pos, table, h, k, v, ks, vs, *, window,
                     split_blocks, warps, max_blocks=MAX_BLOCKS):
    """The split sweep's arithmetic for one item: ``q_rows`` (n, D) bf16
    values at positions ``pos`` against kv head ``h`` of the pools
    (float32 bf16 values or int8, with scales) through block-table row
    ``table``.  Each split's 16-key tiles go to ``warps`` warps in turn;
    a warp keeps a base-2 online softmax in float32, rounds its weights
    (times v_scale for int8) to bf16 before p . v; warps, then splits,
    merge with exp2(m - M) in a fixed order; the output is rounded to
    bf16."""
    bs = k.shape[1]
    n, dim = q_rows.shape
    scale = np.log2(np.e) / np.sqrt(dim)
    lo, hi = tpa.needed_keys(min(pos), max(pos), window, max_blocks, bs)
    pos_t = torch.tensor(pos)[:, None]
    parts = []
    for k_lo, k_hi in tpa.item_splits(lo, hi, bs, split_blocks):
        n_tiles = (k_hi - k_lo) // 16 + 1 if k_hi >= k_lo else 0
        states = []
        for w in range(warps):
            m = torch.full((n,), -1e30)
            l = torch.zeros(n)
            o = torch.zeros(n, dim)
            for i in range(w, n_tiles, warps):
                kpos = torch.arange(k_lo + 16 * i, k_lo + 16 * i + 16)
                live = kpos <= k_hi
                kp = kpos.clamp(max=max(k_hi, 0))
                rows = table[kp // bs].long() * bs + kp % bs
                kt = k.reshape(-1, k.shape[2], dim)[rows, h].float()
                vt = v.reshape(-1, v.shape[2], dim)[rows, h].float()
                kt, vt = kt * live[:, None], vt * live[:, None]
                s = (q_rows @ kt.T) * scale
                if ks is not None:
                    s = s * ks.reshape(-1, ks.shape[2])[rows, h] * live
                ok = live & (kpos <= pos_t)
                if window:
                    ok &= (pos_t - kpos) < window
                s = torch.where(ok, s, torch.tensor(-1e30))
                m_new = torch.maximum(m, s.max(dim=1).values)
                corr = torch.exp2(m - m_new)
                p = torch.exp2(s - m_new[:, None])
                l = l * corr + p.sum(dim=1)
                if vs is not None:
                    p = p * vs.reshape(-1, vs.shape[2])[rows, h] * live
                o = o * corr[:, None] + p.bfloat16().float() @ vt
                m = m_new
            states.append((m, l, o))
        M = torch.stack([st[0] for st in states]).max(dim=0).values
        f = [torch.exp2(st[0] - M) for st in states]
        parts.append((M, sum(fi * st[1] for fi, st in zip(f, states)),
                      sum(fi[:, None] * st[2] for fi, st in zip(f, states))))
    M = torch.stack([pt[0] for pt in parts]).max(dim=0).values
    f = [torch.exp2(pt[0] - M) for pt in parts]
    L = sum(fi * pt[1] for fi, pt in zip(f, parts))
    O = sum(fi[:, None] * pt[2] for fi, pt in zip(f, parts))
    return (O / L.clamp(min=1e-30)[:, None]).bfloat16().float()


def _emulate_per_token(d, G, window, split_blocks, warps):
    """The per-token read (B2) through :func:`_sweep_emulation`, item by
    item: one token's G query heads of each kv head."""
    q = _bf16v(d["q"])
    k, v, ks, vs = _emulation_pools(d)
    T = q.shape[0]
    out = torch.zeros_like(q)
    for t in range(T):
        pos = int(d["token_pos"][t])
        table = torch.from_numpy(d["token_tables"][t])
        for h in range(HKV):
            heads = slice(h * G, (h + 1) * G)
            out[t, heads] = _sweep_emulation(
                q[t, heads], [pos] * G, table, h, k, v, ks, vs,
                window=window, split_blocks=split_blocks, warps=warps)
    return out


def _emulate_chunk(d, G, window, split_blocks, warps):
    """The rectangular read (B3) through :func:`_sweep_emulation`: each
    lane's real rows (token r // G, query head r % G) in groups of 16."""
    q = _bf16v(d["q"])
    k, v, ks, vs = _emulation_pools(d)
    B, C = q.shape[:2]
    out = torch.zeros_like(q)
    for b in range(B):
        table = torch.from_numpy(d["tables"][b])
        n = int(d["lens"][b]) * G
        for h in range(HKV):
            for r0 in range(0, n, 16):
                rows = range(r0, min(n, r0 + 16))
                qr = torch.stack([q[b, r // G, h * G + r % G] for r in rows])
                pos = [int(d["starts"][b]) + r // G for r in rows]
                o = _sweep_emulation(qr, pos, table, h, k, v, ks, vs,
                                     window=window,
                                     split_blocks=split_blocks, warps=warps)
                for i, r in enumerate(rows):
                    out[b, r // G, h * G + r % G] = o[i]
    return out


def _emulate_tiled(d, G, window, split_blocks, warps):
    """The segment-tiled read (B1) through :func:`_sweep_emulation`: each
    real tile's rows (token lo + r // G, query head r % G, at position
    pos0 + r // G) in items of 16 of its (hi - lo) x G rows."""
    q = _bf16v(d["q"])
    k, v, ks, vs = _emulation_pools(d)
    meta = d["meta"]
    out = torch.zeros_like(q)
    for t in range(meta.shape[1]):
        lo, hi = int(meta[tref.TILE_LO, t]), int(meta[tref.TILE_HI, t])
        pos0, lane = int(meta[tref.TILE_POS0, t]), int(meta[tref.TILE_LANE, t])
        table = torch.from_numpy(d["tables"][lane])
        n = (hi - lo) * G
        for h in range(HKV):
            for r0 in range(0, n, 16):
                rows = range(r0, min(n, r0 + 16))
                qr = torch.stack([q[lo + r // G, h * G + r % G] for r in rows])
                pos = [pos0 + r // G for r in rows]
                o = _sweep_emulation(qr, pos, table, h, k, v, ks, vs,
                                     window=window,
                                     split_blocks=split_blocks, warps=warps)
                for i, r in enumerate(rows):
                    out[lo + r // G, h * G + r % G] = o[i]
    return out


def _emulation_pools(d):
    """Pools as the kernels read them: bf16 values (int8 stays int8, with
    float32 scales)."""
    if d["ks"] is not None:
        return (torch.from_numpy(d["k"]), torch.from_numpy(d["v"]),
                torch.from_numpy(d["ks"]), torch.from_numpy(d["vs"]))
    return _bf16v(d["k"]), _bf16v(d["v"]), None, None


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("bs", [4, 16])
def test_split_plan_covers_needed_blocks_once(bs, window):
    """The host-side split planner: every block a range needs lies in
    exactly one split, in order, none wholly before the window; with
    CTAs that fill two waves there is one split; the launch's n_splits
    bounds every range the span allows."""
    max_blocks = 64
    for n_ctas in (10, 263, 264, 5000):
        for tokens in (1, 5, 17):
            span = tpa.span_blocks(max_blocks, bs, window, tokens)
            sb, n_splits = tpa.split_plan(n_ctas, span, bs)
            if n_ctas >= tpa.FILL_CTAS:
                assert n_splits == 1
            else:
                assert sb * bs == max(bs, tpa.SPLIT_KEYS)
            for minpos in (0, 3, 15, 16, 255, 256, 300, 700):
                if minpos >= max_blocks * bs:
                    continue                    # past the table
                maxpos = min(minpos + tokens - 1, max_blocks * bs - 1)
                lo, hi = tpa.needed_keys(minpos, maxpos, window, max_blocks,
                                         bs)
                splits = tpa.item_splits(lo, hi, bs, sb)
                assert 1 <= len(splits) <= n_splits
                keys = [kk for a, b in splits for kk in range(a, b + 1)]
                assert keys == list(range(lo, hi + 1))    # once, in order
                blocks = [sorted({kk // bs for kk in range(a, b + 1)})
                          for a, b in splits]
                flat = [j for bl in blocks for j in bl]
                assert flat == sorted(set(flat))          # whole blocks
                assert all(len(bl) <= sb for bl in blocks)
                if window:
                    assert flat[0] == max(0, minpos - window + 1) // bs
    assert tpa.item_splits(5, 4, 16, 4) == [(5, 4)]       # empty: one split


# the emulation against the oracle: the bf16 roundings of the output and
# of the softmax weights are the whole difference, each up to 2^-9 of the
# largest |v| a row mixes (|v| < 4.5 in the bf16 pools, < 2.6 in the
# int8 ones).  Readings: 7.7e-3 with bf16 pools (the output's rounding:
# the same without the weights' rounding) and 1.24e-2 with int8 pools,
# where the weights rounded with v_scale folded in add up to 4e-3 over
# the output's rounding alone (5.9e-3)
EMULATION_ATOL = 2e-2


@pytest.mark.parametrize("G,window,quantized", [
    (1, 0, False), (1, 5, True), (9, 5, False), (9, 0, True)],
    ids=["G1-bf16", "G1-window-int8", "G9-window-bf16", "G9-int8"])
def test_split_arithmetic_matches_reference_oracle(jax_side, G, window,
                                                   quantized):
    """The split sweep's arithmetic (:func:`_sweep_emulation`: tiles dealt
    to warps, split partials merged, bf16 weights with v_scale folded in
    for int8) against the reference's jnp oracles on the SEGMENT_MIXES
    and CHUNK_CASES inputs, rounded to bf16 as the kernels read them:
    every real row within EMULATION_ATOL, whatever the split size (one
    block, two, or no cut) and the number of warps (2 at D 256, 4
    below)."""
    jnp, jref = jax_side["jnp"], jax_side["oracles"]
    worst = 0.0
    for mix in sorted(SEGMENT_MIXES):
        d = _ragged_setup(mix, G, quantized)
        for n in ("q", "k", "v"):
            if d[n].dtype == np.float32:
                d[n] = _bf16v(d[n]).numpy()
        want = np.asarray(jref.paged_attention_ragged_reference(
            *(jnp.asarray(d[n]) for n in ("q", "k", "v", "token_tables",
                                          "token_pos")),
            window=window, **_jax_scales(jnp, d)))
        for split_blocks, warps in ((1, 4), (2, 2), (MAX_BLOCKS, 4)):
            got = _emulate_per_token(d, G, window, split_blocks, warps)
            err = np.abs(got.numpy() - want)[:d["T"]].max()
            worst = max(worst, err)
    for case in sorted(CHUNK_CASES):
        d = _chunk_setup(case, G, quantized)
        for n in ("q", "k", "v"):
            if d[n].dtype == np.float32:
                d[n] = _bf16v(d[n]).numpy()
        want = np.asarray(jref.paged_attention_chunk_reference(
            *(jnp.asarray(d[n]) for n in ("q", "k", "v", "tables",
                                          "starts")),
            window=window, **_jax_scales(jnp, d)))
        for split_blocks, warps in ((1, 2), (MAX_BLOCKS, 4)):
            got = _emulate_chunk(d, G, window, split_blocks, warps).numpy()
            for b, n in enumerate(d["lens"]):
                worst = max(worst, np.abs(got[b, :n] - want[b, :n]).max(
                    initial=0.0))
    assert worst <= EMULATION_ATOL, worst
    assert worst > 0      # the rounding is there: no exact path slipped in


@pytest.mark.parametrize("G,window,quantized", [
    (1, 0, False), (1, 5, True), (9, 5, False), (9, 0, True)],
    ids=["G1-bf16", "G1-window-int8", "G9-window-bf16", "G9-int8"])
def test_tiled_split_arithmetic_matches_reference_oracle(jax_side, G, window,
                                                         quantized):
    """The segment-tiled read's split sweep (:func:`_emulate_tiled`: each
    tile cut into items of 16 rows, tiles dealt to warps, split partials
    merged, bf16 weights with v_scale folded in for int8) against the
    reference's tiled jnp oracle on every TILED_MIXES case (windows
    straddling segment boundaries, segments smaller and larger than a
    tile, all decodes), inputs rounded to bf16 as the kernel reads them:
    every real row within EMULATION_ATOL, whatever the split size (one
    block, two, or no cut) and the number of warps."""
    jnp = jax_side["jnp"]
    worst = 0.0
    for mix in sorted(TILED_MIXES):
        d = _setup(mix, G, quantized)
        for n in ("q", "k", "v"):
            if d[n].dtype == np.float32:
                d[n] = _bf16v(d[n]).numpy()
        want = np.asarray(jax_side["ref"](
            *(jnp.asarray(d[n]) for n in ("q", "k", "v", "tables", "meta",
                                          "row_tile")),
            tile=d["tile"], window=window, **_jax_scales(jnp, d)))
        for split_blocks, warps in ((1, 4), (2, 2), (MAX_BLOCKS, 4)):
            got = _emulate_tiled(d, G, window, split_blocks, warps)
            err = np.abs(got.numpy() - want)[:d["T"]].max()
            worst = max(worst, err)
    assert worst <= EMULATION_ATOL, worst
    assert worst > 0


# split-sweep cases on the card (bs 16, so SPLIT_KEYS = 16 blocks): lanes
# (q_start, q_len) of a C = 5 chunk: a context inside one split (100),
# one exactly on a split boundary (256) and one key past it (257), deep
# ones (605, 1024 = four whole splits), an empty lane (ctx 0); C x G rows
# of 5, 20 and 45 (not multiples of 16); the window of 300 starts inside
# a split
SPLIT_LANES = [(95, 5), (251, 5), (252, 5), (600, 5), (0, 0), (1019, 5)]
SPLIT_BS, SPLIT_MAX_BLOCKS = 16, 64


def _split_case(G, dim, pool, seed=0):
    """numpy inputs of a split-sweep case at bs 16: the rectangular batch
    of SPLIT_LANES (C = 5) and the same tokens as a per-token stream,
    padded with null-table, position-0 tokens to a power of two."""
    rng = np.random.default_rng(seed)
    B, C = len(SPLIT_LANES), 5
    num_blocks = B * SPLIT_MAX_BLOCKS + 1
    shape = (num_blocks, SPLIT_BS, HKV, dim)
    if pool == "int8_bf16q":
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(0.002, 0.02, shape[:3]).astype(np.float32)
        vs = rng.uniform(0.002, 0.02, shape[:3]).astype(np.float32)
    else:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        ks = vs = None
    tables = np.zeros((B, SPLIT_MAX_BLOCKS), np.int32)
    free = list(rng.permutation(np.arange(1, num_blocks)))
    for lane, (start, n) in enumerate(SPLIT_LANES):
        for j in range(-(-(start + n) // SPLIT_BS)):
            tables[lane, j] = free.pop()
    q = rng.standard_normal((B, C, HKV * G, dim)).astype(np.float32)
    starts = np.array([st for st, _ in SPLIT_LANES], np.int32)
    lens = np.array([n for _, n in SPLIT_LANES], np.int32)
    tok = [(b, c) for b, (_, n) in enumerate(SPLIT_LANES) for c in range(n)]
    T_pad = 1 << (len(tok) - 1).bit_length()
    qt = np.zeros((T_pad, HKV * G, dim), np.float32)
    token_tables = np.zeros((T_pad, SPLIT_MAX_BLOCKS), np.int32)
    token_pos = np.zeros((T_pad,), np.int32)
    for i, (b, c) in enumerate(tok):
        qt[i] = q[b, c]
        token_tables[i] = tables[b]
        token_pos[i] = starts[b] + c
    qt[len(tok):] = rng.standard_normal(qt[len(tok):].shape)
    return dict(q=q, k=k, v=v, ks=ks, vs=vs, tables=tables, starts=starts,
                lens=lens, qt=qt, token_tables=token_tables,
                token_pos=token_pos, T=len(tok))


# the card tests' limit for bf16 inputs: the plain version rounds scores
# and weights to bf16, the kernels keep scores in float32
BF16_TOL = 5e-2




@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["f32", "bf16", "int8", "int8_bf16q"])
def test_cuda_per_token_kernel_matches_plain_version(cuda_device, pool):
    """The per-token Hopper kernels against their plain version on the
    card, every SEGMENT_MIXES case (padding tokens included), G in {1,
    4}, window in {0, 5}, head dim 64: float32 q (f32 and int8 pools) on
    the FMA kernel, bf16 q (bf16 pools, and int8 pools under
    "int8_bf16q") on the split sweep.  The split sweep also runs the
    SPLIT_LANES stream at G in {1, 4, 9} and D in {64, 128, 256}, with
    and without a window, and returns the same bits twice."""
    tc = pool in ("bf16", "int8_bf16q")
    before = tpa.launch_counts[tpa.RAGGED]
    calls = 0
    for mix in sorted(SEGMENT_MIXES):
        for G in (1, 4):
            for window in (0, 5):
                d = _ragged_setup(mix, G, pool.startswith("int8"), dim=64)
                p = _cuda_pools(d, cuda_device, pool)
                q = _cuda_q(d, cuda_device, pool)
                args = (q, p["k"], p["v"], _t(d["token_tables"], cuda_device),
                        _t(d["token_pos"], cuda_device))
                kw = dict(window=window, k_scale=p["ks"], v_scale=p["vs"])
                want = tref.paged_attention_ragged_reference(*args, **kw)
                got = ops.paged_attention_ragged(*args, **kw)
                calls += 1
                torch.cuda.synchronize()
                assert torch.isfinite(got).all()
                tol = BF16_TOL if tc else 1e-4
                T = d["T"]
                torch.testing.assert_close(got[:T].float(), want[:T].float(),
                                           atol=tol, rtol=tol)
    assert tpa.launch_counts[tpa.RAGGED] == before + calls
    if not tc:
        return
    for G in (1, 4, 9):
        for dim in (64, 128, 256):
            for window in (0, 300):
                d = _split_case(G, dim, pool)
                p = _cuda_pools(d, cuda_device, pool)
                q = _t(d["qt"], cuda_device).bfloat16()
                args = (q, p["k"], p["v"], _t(d["token_tables"], cuda_device),
                        _t(d["token_pos"], cuda_device))
                kw = dict(window=window, k_scale=p["ks"], v_scale=p["vs"])
                want = tref.paged_attention_ragged_reference(*args, **kw)
                got = ops.paged_attention_ragged(*args, **kw)
                again = ops.paged_attention_ragged(*args, **kw)
                torch.cuda.synchronize()
                assert torch.isfinite(got).all()    # padding tokens too
                assert torch.equal(got, again)
                T = d["T"]
                torch.testing.assert_close(got[:T].float(), want[:T].float(),
                                           atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["f32", "bf16", "int8", "int8_bf16q"])
def test_cuda_rows_kernel_matches_plain_version(cuda_device, pool):
    """The rectangular Hopper kernels against their plain version on the
    card: every CHUNK_CASES case and a 70-token chunk beside short lanes
    (several row groups per lane), G in {1, 4}, window in {0, 5}, head
    dim 64; padded rows come back as zeros; C = 1 through the decode
    wrapper.  float32 q runs the FMA kernel, bf16 q (bf16 pools, and int8
    pools under "int8_bf16q") the split sweep, which also runs the
    SPLIT_LANES batch (an empty lane among them) at G in {1, 4, 9} and D
    in {64, 128, 256}, with and without a window, and its decode, and
    returns the same bits twice."""
    tc = pool in ("bf16", "int8_bf16q")
    tol = BF16_TOL if tc else 1e-4
    cases = [(c, None) for c in sorted(CHUNK_CASES)]
    cases.append((None, (70, [3, 0, 20], [70, 5, 1])))
    for case, custom in cases:
        for G in (1, 4):
            for window in (0, 5):
                if custom is None:
                    d = _chunk_setup(case, G, pool.startswith("int8"),
                                     dim=64)
                else:
                    C, st, ln = custom
                    d = _chunk_setup(None, G, pool.startswith("int8"),
                                     dim=64, C=C, starts=st, lens=ln,
                                     max_blocks=24)
                p = _cuda_pools(d, cuda_device, pool)
                q = _cuda_q(d, cuda_device, pool)
                tables = _t(d["tables"], cuda_device)
                starts = _t(d["starts"], cuda_device)
                lens = _t(d["lens"], cuda_device)
                kw = dict(window=window, k_scale=p["ks"], v_scale=p["vs"])
                want = tref.paged_attention_chunk_reference(
                    q, p["k"], p["v"], tables, starts, **kw)
                got = ops.paged_attention_chunk(q, p["k"], p["v"], tables,
                                                starts, lens, **kw)
                torch.cuda.synchronize()
                for b, n in enumerate(d["lens"]):
                    torch.testing.assert_close(got[b, :n].float(),
                                               want[b, :n].float(),
                                               atol=tol, rtol=tol)
                    assert (got[b, n:] == 0).all()
                if q.shape[1] == 1:
                    dec = ops.paged_attention(q[:, 0], p["k"], p["v"],
                                              tables, starts + 1, **kw)
                    torch.testing.assert_close(dec, got[:, 0], rtol=0,
                                               atol=0)
    if not tc:
        return
    for G in (1, 4, 9):
        for dim in (64, 128, 256):
            for window in (0, 300):
                d = _split_case(G, dim, pool)
                p = _cuda_pools(d, cuda_device, pool)
                q = _t(d["q"], cuda_device).bfloat16()
                tables = _t(d["tables"], cuda_device)
                starts = _t(d["starts"], cuda_device)
                lens = _t(d["lens"], cuda_device)
                kw = dict(window=window, k_scale=p["ks"], v_scale=p["vs"])
                want = tref.paged_attention_chunk_reference(
                    q, p["k"], p["v"], tables, starts, **kw)
                got = ops.paged_attention_chunk(q, p["k"], p["v"], tables,
                                                starts, lens, **kw)
                again = ops.paged_attention_chunk(q, p["k"], p["v"], tables,
                                                  starts, lens, **kw)
                torch.cuda.synchronize()
                assert torch.equal(got, again)
                for b, n in enumerate(d["lens"]):
                    torch.testing.assert_close(got[b, :n].float(),
                                               want[b, :n].float(),
                                               atol=BF16_TOL, rtol=BF16_TOL)
                    assert (got[b, n:] == 0).all()
                # decode: the last real token of each lane, C = 1
                last = (lens - 1).clamp(min=0).long()
                qd = q[torch.arange(len(last)), last].contiguous()
                ctx = starts + lens
                dec = ops.paged_attention(qd, p["k"], p["v"], tables, ctx,
                                          **kw)
                dwant = tref.paged_attention_reference(
                    qd, p["k"], p["v"], tables, ctx, **kw)
                torch.cuda.synchronize()
                live = lens > 0
                torch.testing.assert_close(dec[live].float(),
                                           dwant[live].float(),
                                           atol=BF16_TOL, rtol=BF16_TOL)
                assert (dec[~live] == 0).all()
