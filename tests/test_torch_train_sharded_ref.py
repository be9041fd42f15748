"""The port's sharded train step against the reference's, on the CPU:
gemma-7b's smoke config on a 2 x 2 ("data", "model") mesh, the port's
four CPU positions against the reference's four virtual CPU devices
(``tests/conftest.py``).

Parameters come from the reference's ``init`` and are carried across by
``from_reference_params`` in float32; the batch is made with numpy from
a seed, its labels -1 at a few positions.  The reference's sharded step
is its launcher's: ``param_specs`` of the host mesh, ``jax.device_put``
and the jitted ``make_train_step_fn``.  Tolerances are those of
``test_torch_lm_train.py``: the bfloat16 steps (``pre_gather`` on both
sides) round at other places in the two frameworks, so losses agree to
1e-2 and gradient norms to 5e-2; the float32 sharded step against the
reference's ``forward(compute_dtype=float32)`` + ``lm_loss`` + ``adamw``
(its ``loss_fn`` always computes in bfloat16) to 1e-5 in loss and
gradient norm and 1e-3 of each leaf's largest in AdamW's moments, and no
weight moves by more than 2 lr.  Checkpoints cross the packages exactly.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.shapes import InputShape
from repro_torch.data.synthetic import lm_token_recurrence
from repro_torch.launch import sharding as sh
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import Mesh
from repro_torch.models.api import build_model
from repro_torch.models.convert import from_reference_params
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.train import checkpoint as ck

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

ARCH = "gemma-7b"
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


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


@pytest.fixture(scope="module")
def setup():
    """The reference's config, API, params and host mesh (2 x 2 over its
    four CPU devices); the port's API, the converted params, their specs
    on the port's 2 x 2 mesh, and a batch."""
    from repro.configs import get_config as jax_get_config
    from repro.models import build_model as jax_build_model
    from repro.launch.mesh import make_host_mesh
    jcfg = jax_get_config(ARCH).smoke_variant()
    japi = jax_build_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    api = build_model(get_config(ARCH).smoke_variant())
    params = from_reference_params(jax.tree.map(np.asarray, jparams),
                                   device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(7)
    out = lm_token_recurrence(torch.from_numpy(rng.integers(0, 512, (B, 1))),
                              torch.from_numpy(rng.integers(0, 3, (B, S))),
                              api.cfg.vocab_size)
    for b, s in [(0, 3), (1, 0), (2, 20), (2, 21)]:
        out["labels"][b, s] = -1
    batch = {k: v.numpy().astype(np.int32) for k, v in out.items()}
    specs = sp.train_specs(api, params, MESH)
    return dict(japi=japi, jparams=jparams, jmesh=make_host_mesh(2),
                api=api, params=params, specs=specs, batch=batch)


def _tb(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _port_step(m, **kw):
    placed = sh.place(m["params"], m["specs"], MESH)
    step, opt = sp.make_train_step_fn(m["api"], InputShape("t", S, B,
                                                           "train"),
                                      mesh=MESH, specs=m["specs"], lr=LR,
                                      **kw)
    p, s, met = step(placed, opt.init(placed), _tb(m["batch"]))
    return p, s, met


def test_bf16_sharded_step_matches_reference_sharded_step(setup):
    """The reference launcher's sharded step (``pre_gather``, bf16) on
    its 2 x 2 mesh against the port's on 2 x 2 CPU positions."""
    from repro.configs.shapes import InputShape as JShape
    from repro.launch import sharding as jsh
    from repro.launch import specs as jspecs
    from repro.launch.mesh import data_axes_of, mesh_axis_sizes
    m = setup
    mesh = m["jmesh"]
    with jax.set_mesh(mesh):
        pspecs = jsh.param_specs(m["jparams"], mesh_axis_sizes(mesh),
                                 data_axes_of(mesh))
        jparams = jax.device_put(m["jparams"], jsh.to_named(pspecs, mesh))
        jstep, jopt = jspecs.make_train_step_fn(
            m["japi"], JShape("t", S, B, "train"), lr=LR, pre_gather=True)
        _, _, jmet = jax.jit(jstep)(jparams, jopt.init(jparams),
                                    {k: jnp.asarray(v)
                                     for k, v in m["batch"].items()})
    placed, _, met = _port_step(m, pre_gather=True)
    assert all(t.dtype == torch.float32 for t in tree_leaves(placed))
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=1e-2)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=5e-2)
    assert float(met["tokens"]) == float(jmet["tokens"]) == B * S - B - 4


def test_float32_sharded_step_matches_reference(setup):
    """The port's float32 sharded step against the reference's float32
    forward, ``lm_loss``, gradient and ``adamw(lr, grad_clip_norm=1.0)``:
    loss, gradient norm, AdamW's moments and the update's size."""
    from repro.models import transformer as jtf
    from repro.optim import adamw as jadamw
    from repro.optim import global_norm as jglobal_norm
    m = setup
    jcfg = m["japi"].cfg

    def loss32(p, b):
        logits, aux = jtf.forward(p, b["tokens"], jcfg,
                                  compute_dtype=jnp.float32)
        return jtf.lm_loss(logits, b["labels"], aux, 0.0)[0]

    jb = {k: jnp.asarray(v) for k, v in m["batch"].items()}
    jloss, jg = jax.jit(jax.value_and_grad(loss32))(m["jparams"], jb)
    jopt = jadamw(LR, grad_clip_norm=1.0)
    _, jstate = jopt.update(jg, jopt.init(m["jparams"]), m["jparams"])
    placed, state, met = _port_step(m, compute_dtype=torch.float32)
    np.testing.assert_allclose(float(met["loss"]), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jglobal_norm(jg)), rtol=1e-5)
    for name in ("m", "v"):
        got = _flat(sh.unshard(state[name], m["specs"], MESH))
        want = _flat(jax.tree.map(np.asarray, jstate[name]))
        assert set(got) == set(want)
        for k, g in got.items():
            scale = np.abs(want[k]).max()
            np.testing.assert_allclose(g.numpy(), want[k],
                                       atol=1e-3 * scale + 1e-12,
                                       err_msg=(name, k))
    whole = sh.unshard(placed, m["specs"], MESH)
    moved = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(whole), tree_leaves(m["params"])))
    assert 0 < moved <= 2 * LR


def test_sharded_checkpoint_crosses_packages(setup, tmp_path):
    """The port's sharded state saved whole restores in the reference,
    and the reference's checkpoint restores into the port's pieces."""
    from repro.train import checkpoint as jck
    m = setup
    placed = sh.place(m["params"], m["specs"], MESH)
    ck.save_placed(str(tmp_path / "port"), 3, placed, m["specs"], MESH)
    tree, _ = jck.restore_checkpoint(str(tmp_path / "port"),
                                     {"params": m["jparams"]})
    want = _flat(jax.tree.map(np.asarray, m["jparams"]))
    got = _flat(jax.tree.map(np.asarray, tree["params"]))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    jck.save_checkpoint(str(tmp_path / "ref"), 5, {"params": m["jparams"]})
    empty = sh._zip_map(lambda p, _: [torch.zeros_like(t) for t in p],
                        placed, m["specs"])
    restored, manifest = ck.restore_placed(str(tmp_path / "ref"), empty,
                                           m["specs"], MESH)
    assert manifest["step"] == 5
    for a, b in zip(tree_leaves(restored), tree_leaves(placed)):
        assert torch.equal(a, b)
