"""The port's sharding rules against the reference's, leaf for leaf.

Every assigned arch at its published width: the port's parameter tree is
built on the ``meta`` device (``launch.specs.abstract_params``) and the
reference's from ``jax.eval_shape``, so nothing is materialized.  Both
trees carry the same leaf paths and shapes; each spec function must then
give the same PartitionSpec at every path (tolerance: exact, compared as
tuples) on the axis sets ``{"data": 1, "model": 4}``, ``{"data": 16,
"model": 16}`` and ``{"pod": 2, "data": 16, "model": 16}``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS
from repro.configs import get_config as jax_get_config
from repro.launch import sharding as jsh
from repro.launch import specs as jspecs
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import (Mesh, data_axes_of, make_host_mesh,
                                     mesh_axis_sizes, mesh_slices)
from repro_torch.launch.specs import abstract_params
from repro_torch.models.api import build_model

AXIS_SETS = {"tp4": {"data": 1, "model": 4},
             "pod": {"data": 16, "model": 16},
             "multipod": {"pod": 2, "data": 16, "model": 16}}
POLICIES = ("baseline", "replicated", "local_recurrent", "fsdp_flat")


def _jax_path(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def _jax_flat(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {_jax_path(p): tuple(s) for p, s in flat}


def _port_flat(tree) -> dict:
    out = {}
    sh._map_with_path(lambda p, s: out.__setitem__(p, tuple(s)), tree)
    return out


@pytest.fixture(scope="module")
def trees():
    """arch -> (reference abstract params, port meta params)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = (
                jspecs.abstract_params(jax_build_model(jax_get_config(arch))),
                abstract_params(build_model(get_config(arch))))
        return cache[arch]
    return get


@pytest.mark.parametrize("axes", sorted(AXIS_SETS))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_specs_equal_reference(trees, arch, axes):
    """``param_specs`` under every policy, and ``serving_param_specs``."""
    jtree, ptree = trees(arch)
    mesh_axes = AXIS_SETS[axes]
    data_axes = tuple(a for a in ("pod", "data") if a in mesh_axes)
    for policy in POLICIES:
        want = _jax_flat(jsh.param_specs(jtree, mesh_axes,
                                         data_axes=data_axes,
                                         policy=policy))
        got = _port_flat(sh.param_specs(ptree, mesh_axes,
                                        data_axes=data_axes, policy=policy))
        assert got == want, (arch, axes, policy)
    assert _port_flat(sh.serving_param_specs(ptree, mesh_axes)) == \
        _jax_flat(jsh.serving_param_specs(jtree, mesh_axes))


@pytest.mark.parametrize("cache_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("axes", sorted(AXIS_SETS))
def test_paged_pool_specs_equal_reference(axes, cache_dtype):
    """``paged_pool_specs`` on gemma-7b's smoke pool (4 kv heads: split
    over a 4-way model axis, replicated over a 16-way one; int8 pools
    and their scales replicate) and qwen3-moe's single kv head."""
    mesh_axes = AXIS_SETS[axes]
    kw = dict(num_blocks=5, block_size=4, max_blocks_per_lane=2)
    jdt = jnp.int8 if cache_dtype == "int8" else jnp.bfloat16
    tdt = torch.int8 if cache_dtype == "int8" else torch.bfloat16
    for arch in ("gemma-7b", "qwen3-moe-235b-a22b"):
        japi = jax_build_model(jax_get_config(arch).smoke_variant())
        jcache = jax.eval_shape(lambda: japi.init_paged_cache(
            2, dtype=jdt, **kw))
        pcache = build_model(get_config(arch).smoke_variant()) \
            .init_paged_cache(2, dtype=tdt, device="meta", **kw)
        want = _jax_flat(jsh.paged_pool_specs(jcache, mesh_axes))
        got = _port_flat(sh.paged_pool_specs(pcache, mesh_axes))
        assert got == want, (arch, axes)
    if axes == "tp4" and cache_dtype == "bf16":
        assert got["scan/k"] == (None,) * 5          # qwen3 smoke: Hkv 1
        gemma = _port_flat(sh.paged_pool_specs(build_model(
            get_config("gemma-7b").smoke_variant()).init_paged_cache(
                2, device="meta", **kw), mesh_axes))
        assert gemma["scan/k"] == (None, None, None, "model", None)


@pytest.mark.parametrize("axes", sorted(AXIS_SETS))
def test_cache_and_batch_specs_equal_reference(axes):
    """``cache_specs`` on llava's dense cache at 128 x 32768 and
    ``batch_spec`` on batches that divide the data axes, some and none."""
    mesh_axes = AXIS_SETS[axes]
    data_axes = tuple(a for a in ("pod", "data") if a in mesh_axes)
    japi = jax_build_model(jax_get_config("llava-next-mistral-7b"))
    jcache = jax.eval_shape(lambda: japi.init_cache(128, 32768))
    pcache = build_model(get_config("llava-next-mistral-7b")).init_cache(
        128, 32768, device="meta")
    assert _port_flat(sh.cache_specs(pcache, mesh_axes, data_axes)) == \
        _jax_flat(jsh.cache_specs(jcache, mesh_axes, data_axes))
    for shape in ((256, 4096), (32, 7), (8, 4), (1, 9)):
        assert tuple(sh.batch_spec(shape, mesh_axes, data_axes)) == \
            tuple(jsh.batch_spec(shape, mesh_axes, data_axes))


def test_spec_for_leaf_equal_reference_on_random_shapes():
    """Any leaf name and shape: the same spec, and it divides the shape."""
    rng = np.random.default_rng(0)
    names = ["wq", "wk", "wo", "w_up", "w_down", "experts_w_gate",
             "embedding", "router", "conv_w", "r_gates", "anything_else"]
    dims = [1, 3, 4, 7, 16, 48, 128, 256, 1000]
    for _ in range(200):
        name = names[rng.integers(len(names))]
        shape = tuple(int(d) for d in rng.choice(dims, rng.integers(1, 5)))
        for axes in AXIS_SETS.values():
            data_axes = tuple(a for a in ("pod", "data") if a in axes)
            got = sh.spec_for_leaf(f"blocks/attn/{name}", shape, axes,
                                   data_axes)
            assert tuple(got) == tuple(jsh.spec_for_leaf(
                f"blocks/attn/{name}", shape, axes, data_axes))
            for d, s in zip(shape, got):
                assert d % sh._axis_size(axes, s) == 0


def test_mesh_helpers_and_shard_tree():
    """Meshes of CPU positions: axis sizes, slices and data axes as the
    reference's; ``shard_tree`` cuts each leaf by its spec, shares
    replicated leaves and contiguous first-dim cuts, and copies the rest
    into contiguous tensors that concatenate back to the leaf."""
    cpu = torch.device("cpu")
    mesh = make_host_mesh(model_parallel=2, devices=[cpu] * 4)
    assert mesh_axis_sizes(mesh) == {"data": 2, "model": 2}
    assert mesh.shape == {"data": 2, "model": 2}
    assert data_axes_of(mesh) == ("data",)
    slices = mesh_slices(mesh)
    assert [s.shape for s in slices] == [{"data": 1, "model": 2}] * 2
    assert mesh_slices(Mesh([cpu] * 3, ("data",)))[2].shape == \
        {"data": 1, "model": 1}
    with pytest.raises(ValueError):
        make_host_mesh(model_parallel=3, devices=[cpu] * 4)
    tree = {"a": {"wq": torch.arange(48.).reshape(2, 4, 6)},
            "emb": torch.arange(24.).reshape(8, 3),
            "n": [torch.ones(3)]}
    specs = {"a": {"wq": sh.P(None, None, "model")},
             "emb": sh.P("model", None), "n": [sh.P(None)]}
    tp = Mesh([cpu] * 2, ("data", "model"), shape=(1, 2))
    shards = sh.shard_tree(tree, specs, tp)
    assert len(shards) == 2
    assert all(s["n"][0] is tree["n"][0] for s in shards)
    assert all(s["a"]["wq"].is_contiguous() for s in shards)
    assert torch.equal(torch.cat([s["a"]["wq"] for s in shards], dim=2),
                       tree["a"]["wq"])
    assert shards[1]["emb"].data_ptr() == tree["emb"][4:].data_ptr()
    assert torch.equal(torch.cat([s["emb"] for s in shards]), tree["emb"])
