"""The port's sharded bf16 train step against the reference launcher's, on
the CPU, for two families beyond the dense and MoE ones: the VLM
(llava's smoke config, ``baseline``, tensor-parallel) and xLSTM
(``fsdp_flat`` with ``pre_gather``, gathered), each on a 2 x 2
("data", "model") mesh: the port's four CPU positions against the
reference's four virtual CPU devices (``tests/conftest.py``).

Parameters come from the reference's ``init`` and are carried across by
``from_reference_params`` in float32; batches are made with numpy from a
seed, labels -1 at a few positions.  The reference's sharded step is its
launcher's (``param_specs`` of the host mesh, ``jax.device_put`` and the
jitted ``make_train_step_fn``); for ``fsdp_flat`` its dry-run's: the
policy's specs, ``pre_gather`` and the batch cut over ("data", "model").
Tolerances are ``test_torch_train_sharded_ref.py``'s: the bf16 steps
round at other places in the two frameworks, so losses agree to 1e-2
and gradient norms to 5e-2.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import sharding as sh
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import Mesh
from repro_torch.models.api import build_model
from repro_torch.models.convert import from_reference_params

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

B, S = 4, 32
LR = 1e-3
CPU = torch.device("cpu")
MESH = Mesh([CPU] * 4, ("data", "model"), shape=(2, 2))


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test, beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, seed):
    """Tokens, next-token labels (-1 at a few positions) and the VLM's
    patch embeddings, as numpy arrays from ``seed``."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:].copy()}
    for b, s in [(0, 3), (1, 0), (2, 20)]:
        batch["labels"][b, s] = -1
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (B, cfg.frontend.n_tokens, cfg.frontend.d_embed),
            dtype=np.float32)
    return batch


@pytest.mark.parametrize("arch,policy", [
    ("llava-next-mistral-7b", "baseline"), ("xlstm-1.3b", "fsdp_flat")])
def test_bf16_sharded_step_matches_reference_sharded_step(arch, policy):
    """The reference's sharded step on its 2 x 2 host mesh against the
    port's on 2 x 2 CPU positions: loss, gradient norm and kept
    tokens."""
    from repro.configs import get_config as jax_get_config
    from repro.configs.shapes import InputShape as JShape
    from repro.launch import sharding as jsh
    from repro.launch import specs as jspecs
    from repro.launch.mesh import make_host_mesh, mesh_axis_sizes
    from repro.models import build_model as jax_build_model
    flat = policy == "fsdp_flat"
    japi = jax_build_model(jax_get_config(arch).smoke_variant())
    jparams = jax.jit(japi.init)(jax.random.PRNGKey(0))
    batch = _batch(japi.cfg, seed=11)
    mesh = make_host_mesh(2)
    axes = mesh_axis_sizes(mesh)
    data_axes = ("data", "model") if flat else ("data",)
    with jax.set_mesh(mesh):
        pspecs = jsh.param_specs(jparams, axes, data_axes, policy=policy)
        placed = jax.device_put(jparams, jsh.to_named(pspecs, mesh))
        jstep, jopt = jspecs.make_train_step_fn(
            japi, JShape("t", S, B, "train"), lr=LR, pre_gather=flat)
        jbatch = {k: jax.device_put(jnp.asarray(v), jsh.to_named(
            jsh.batch_spec(v.shape, axes, data_axes), mesh))
            for k, v in batch.items()}
        _, _, jmet = jax.jit(jstep)(placed, jax.jit(jopt.init)(placed),
                                    jbatch)

    api = build_model(get_config(arch).smoke_variant())
    params = from_reference_params(jax.tree.map(np.asarray, jparams),
                                   device="cpu", dtype=torch.float32)
    specs = sp.train_specs(api, params, MESH, policy)
    assert sp.gathers_whole(api, specs) == flat
    placed = sh.place(params, specs, MESH)
    step, opt = sp.make_train_step_fn(api, InputShape("t", S, B, "train"),
                                      mesh=MESH, specs=specs, lr=LR,
                                      pre_gather=flat)
    _, _, met = step(placed, opt.init(placed),
                     {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=1e-2)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=5e-2)
    assert float(met["tokens"]) == float(jmet["tokens"]) == B * S - 3
