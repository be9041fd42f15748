"""The port's segment-tiled paged attention against the reference's.

Inputs are made with numpy from a seed and fed to both packages: the
port's plain version (``repro_torch.kernels.ref``) is held to the
reference's Pallas kernel in interpret mode and to the reference's jnp
oracle, on real rows only, with ``allclose`` at float32 tolerance (the
two oracles differ at rounding level between themselves, so exact
equality is never asked).  The CUDA kernel itself is held to the plain
version on the card; that case skips where there is no card.  The JAX
side is imported by the tests that use it, so that the CUDA case also
runs on a machine that has no JAX:

    python -m pytest -q tests/test_torch_paged_attention.py -k cuda
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
HKV, D, BS, MAX_BLOCKS = 2, 32, 4, 8


@pytest.fixture
def jax_side():
    """The reference package's kernel, oracle and tile-map builder."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.paged_attention import paged_attention_ragged_tiled
    from repro.kernels.ref import paged_attention_ragged_tiled_reference
    from repro.serving.batch import build_tile_map as jax_build_tile_map
    return dict(jnp=jnp, kernel=paged_attention_ragged_tiled,
                ref=paged_attention_ragged_tiled_reference,
                build_tile_map=jax_build_tile_map)


def _setup(mix, G, quantized, seed=0, jax_side=None, dim=D):
    """numpy inputs: q (T_pad, H, D), pools, scales, per-lane tables and
    the tile map (the reference's and the port's builders must agree)."""
    tile, segments, T_pad = TILED_MIXES[mix]
    rng = np.random.default_rng(seed)
    n_lanes = len(segments)
    num_blocks = n_lanes * MAX_BLOCKS + 1
    H = HKV * G
    q = rng.standard_normal((T_pad, H, dim)).astype(np.float32)
    shape = (num_blocks, BS, HKV, dim)
    if quantized:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(0.002, 0.02, shape[:3]).astype(np.float32)
        vs = rng.uniform(0.002, 0.02, shape[:3]).astype(np.float32)
    else:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        ks = vs = None
    tables = np.zeros((n_lanes, MAX_BLOCKS), np.int32)
    free = list(range(1, num_blocks))
    offs, lens, lanes, pos0 = [], [], [], []
    off = 0
    for lane, (start, n) in enumerate(segments):
        for j in range(-(-(start + n) // BS)):
            tables[lane, j] = free.pop(0)
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


def _torch_args(d, device="cpu"):
    t = {name: (None if d[name] is None
                else torch.from_numpy(d[name]).to(device))
         for name in ("q", "k", "v", "ks", "vs", "tables", "meta",
                      "row_tile")}
    return t


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
@pytest.mark.parametrize("G", [1, 4])
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


@pytest.mark.parametrize("pool", ["f32", "bf16", "int8"])
def test_cuda_kernel_matches_plain_version(cuda_device, pool):
    """The Hopper kernel against its plain version on the card, every
    TILED_MIXES case, G in {1, 4}, window in {0, 5}, head dim 64 (the
    kernel is built for 64, 128 and 256)."""
    for mix in sorted(TILED_MIXES):
        for G in (1, 4):
            for window in (0, 5):
                d = _setup(mix, G, pool == "int8", dim=64)
                t = _torch_args(d, cuda_device)
                if pool == "bf16":
                    t["q"] = t["q"].bfloat16()
                    t["k"], t["v"] = t["k"].bfloat16(), t["v"].bfloat16()
                args = (t["q"], t["k"], t["v"], t["tables"], t["meta"],
                        t["row_tile"])
                kw = dict(tile=d["tile"], window=window, k_scale=t["ks"],
                          v_scale=t["vs"])
                want = tref.paged_attention_ragged_tiled_reference(
                    *args, **kw)
                got = ops.paged_attention_ragged_tiled(*args, **kw)
                torch.cuda.synchronize()
                T = d["T"]
                # bf16: the plain version rounds scores and weights to
                # bf16, the kernel keeps scores in float32
                tol = 5e-2 if pool == "bf16" else 1e-4
                torch.testing.assert_close(got[:T].float(),
                                           want[:T].float(), atol=tol,
                                           rtol=tol)
