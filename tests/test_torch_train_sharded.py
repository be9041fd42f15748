"""Sharded training of the port on CPU positions, in float32: the sharded
step against the one-position step.

``launch/specs.py::make_train_step_fn(mesh=)`` trains the dense and MoE
families over a ``("data", "model")`` mesh: float32 masters stored once
as ``sharding.place``'s pieces, each position's local tree gathered over
"data", each data slice tensor-parallel through ``transformer.tp_loss_fn``
(the reduces and gathers autograd Functions with backward duals), the
slices' loss sums added before dividing and the MoE aux from the slices'
averaged balance means.  Positions are ``torch.device("cpu")`` repeated.

Tolerances.  In float32 the sharded step differs from the one-position
step only by the order of sums (the reduces' partial products, the data
slices' gradients), so loss, gradient norm and every post-AdamW
parameter (from ``unshard``) are held to ``allclose(rtol=1e-5,
atol=1e-6)``.  The steps run at lr 1e-5: at step 1 AdamW moves a weight
by lr * g / (|g| + 1e-8), and where |g| is at 1e-5 of its leaf's largest
(rounding level) another summation order moves the update by a few % of
lr on a few weights in a million, which lr 1e-5 keeps under atol while
a wrong sign or a missed update (an error of lr or 2 lr) still shows.  ``pre_gather`` casts the pieces to bfloat16
before the gather, so each position's weight gradient is rounded to
bfloat16 and the data slices' are added in bfloat16 (as the reference's
bf16 gather is differentiated): that step is held to the one-position
``pre_gather`` step at bfloat16's rounding, loss to 1e-5 (the forward is
the same), gradient norm to 1e-4 and each gradient element (AdamW's
first moment) within 2^-6 of its value plus 2^-8 of its leaf's largest.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.shapes import InputShape
from repro_torch.data.synthetic import lm_token_batch
from repro_torch.launch import sharding as sh
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import Mesh
from repro_torch.models import moe as moe_lib
from repro_torch.models import transformer as tf
from repro_torch.models.api import build_model
from repro_torch.optim.optimizers import tree_leaves

CPU = torch.device("cpu")
B, S = 4, 32
LR = 1e-5
SHAPE = InputShape("test_sharded", S, B, "train")
F32 = dict(lr=LR, compute_dtype=torch.float32)
CASES = [("gemma-7b", None), ("deepseek-moe-16b", "gshard"),
         ("deepseek-moe-16b", "gather")]
MESHES = [(1, 2), (1, 4), (2, 2), (4, 1)]        # (dp, tp)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: the sharded steps run tp times the
    small ops, and beside the suite's other workers more threads only
    contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(dp, tp):
    return Mesh([CPU] * (dp * tp), ("data", "model"), shape=(dp, tp))


def _cfg(arch, impl=None):
    cfg = get_config(arch).smoke_variant()
    if impl:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               impl=impl))
    return cfg


def _batch(vocab, seed=1):
    """A bigram batch with labels -1 over part of row 0 (unevenly over
    the data slices)."""
    g = torch.Generator()
    g.manual_seed(seed)
    batch = lm_token_batch(g, B, S, vocab, device="cpu")
    batch["labels"][0, 3:9] = -1
    return batch


@pytest.fixture(scope="module")
def models():
    """(arch, impl) -> the API, float32 params, a batch and the
    one-position float32 step's (params, opt_state, metrics), without and
    with pre_gather."""
    out = {}
    torch.set_num_threads(1)
    for arch, impl in CASES:
        api = build_model(_cfg(arch, impl))
        params = api.init(seed=0, device="cpu", dtype=torch.float32)
        batch = _batch(api.cfg.vocab_size)
        ref = {}
        for pg in (False, True):
            step, opt = sp.make_train_step_fn(api, SHAPE, pre_gather=pg,
                                              **F32)
            ref[pg] = step(params, opt.init(params), batch)
        out[arch, impl] = dict(api=api, params=params, batch=batch, ref=ref)
    return out


def _sharded(m, dp, tp, batch=None, **kw):
    """The sharded step from ``m``'s params on a dp x tp mesh: (whole
    params after it, whole opt state, metrics, the step)."""
    mesh = _mesh(dp, tp)
    specs = sp.train_specs(m["api"], m["params"], mesh)
    placed = sh.place(m["params"], specs, mesh)
    step, opt = sp.make_train_step_fn(m["api"], SHAPE, mesh=mesh,
                                      specs=specs, **{**F32, **kw})
    p, s, met = step(placed, opt.init(placed), m["batch"] if batch is None
                     else batch)
    state = {k: sh.unshard(s[k], specs, mesh) for k in ("m", "v")}
    return sh.unshard(p, specs, mesh), state, met, step


def _forward_count(cfg, plan) -> int:
    """The forward's reduces and gathers by the step design: the
    embedding's reduce and the logits' gather, one reduce per cut
    sublayer, and a gather of cut router logits."""
    n = int(plan.embed) + int(plan.head)
    for lp in plan.layers:
        ffn = [v for k, v in lp.items() if k not in ("attn", "router")]
        n += int(lp["attn"]) + int(any(ffn)) + int(lp.get("router", False))
    return n


def _step_count(cfg, plan, remat=True) -> int:
    """A train step's: the forward's, each one's backward dual, and
    under per-layer remat the layers' forward ones again."""
    f = _forward_count(cfg, plan)
    return 2 * f + (f - int(plan.embed) - int(plan.head) if remat else 0)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("case", CASES, ids=lambda c: c[1] or c[0])
def test_sharded_step_equals_one_position(models, case, mesh):
    """Loss, metrics, gradient norm and every post-AdamW parameter of the
    float32 sharded step against the one-position step, and the design
    count of collectives a slice."""
    m = models[case]
    want_p, want_s, want_m = m["ref"][False]
    got_p, _, got_m, step = _sharded(m, *mesh)
    for k in want_m:
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert set(got_m) == set(want_m)
    for a, b in zip(tree_leaves(got_p), tree_leaves(want_p)):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    cfg = m["api"].cfg
    assert [p.collectives for p in step.plans] == \
        [_step_count(cfg, p) for p in step.plans]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[1] or c[0])
def test_pre_gather_step_matches_one_position(models, case):
    """DP 4 x 1 with ``pre_gather`` against the one-position
    ``pre_gather`` step, at bfloat16's rounding of the gradients."""
    m = models[case]
    _, want_s, want_m = m["ref"][True]
    _, got_s, got_m, _ = _sharded(m, 4, 1, pre_gather=True)
    np.testing.assert_allclose(float(got_m["loss"]), float(want_m["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(got_m["grad_norm"]),
                               float(want_m["grad_norm"]), rtol=1e-4)
    for a, b in zip(tree_leaves(got_s["m"]), tree_leaves(want_s["m"])):
        scale = float(b.abs().max())
        assert bool(((a - b).abs() <= 2 ** -6 * b.abs()
                     + 2 ** -8 * scale).all())


def test_uneven_label_masks_give_the_global_loss(models):
    """The second trap: with most of data slice 0's labels masked, the
    slices' loss sums added before dividing give the one-position loss,
    where the mean of the slices' own losses is off by far more than the
    tolerance."""
    m = models["gemma-7b", None]
    batch = {k: v.clone() for k, v in m["batch"].items()}
    batch["labels"][:2, 4:] = -1
    loss = sp.make_loss_for_shape(m["api"], SHAPE,
                                  compute_dtype=torch.float32)
    want, _ = loss(m["params"], batch)
    halves = [float(loss(m["params"], {k: v[i:i + 2] for k, v in
                                       batch.items()})[0]) for i in (0, 2)]
    _, _, got_m, _ = _sharded(m, 2, 1, batch=batch)
    np.testing.assert_allclose(float(got_m["loss"]), float(want), rtol=1e-5)
    assert abs(np.mean(halves) - float(want)) > 1e-3


def test_moe_aux_is_the_global_batch_aux(models):
    """An MoE batch whose data slices route differently gives the global
    aux (the slices' balance means averaged before their product), not
    the mean of the slices' aux values."""
    m = models["deepseek-moe-16b", "gshard"]
    api, params, batch = m["api"], m["params"], m["batch"]
    slices = [{k: v[i:i + 2] for k, v in batch.items()} for i in (0, 2)]
    auxes = [float(api.forward(params, b["tokens"],
                               compute_dtype=torch.float32)[1])
             for b in slices]
    want = float(m["ref"][False][2]["moe_aux"])
    _, _, got_m, _ = _sharded(m, 2, 2)
    np.testing.assert_allclose(float(got_m["moe_aux"]), want, rtol=1e-5)
    assert abs(np.mean(auxes) - want) > 1e-3, (auxes, want)


def test_replicated_leaf_gradient_and_clip(models):
    """The first trap: a replicated leaf (the norm scales) is one piece,
    read by every position; its gradient sums over them, and the norm
    counts it once, so the clip (active: the norm is above 1) and AdamW's
    moments match the one-position step (to 1e-5 of the leaf's
    largest)."""
    m = models["gemma-7b", None]
    _, want_s, want_m = m["ref"][False]
    mesh = _mesh(1, 2)
    specs = sp.train_specs(m["api"], m["params"], mesh)
    placed = sh.place(m["params"], specs, mesh)
    assert len(placed["final_norm"]["scale"]) == 1
    assert sum(t.numel() for t in tree_leaves(placed)) == \
        sum(t.numel() for t in tree_leaves(m["params"]))
    _, got_s, got_m, _ = _sharded(m, 1, 2)
    assert float(want_m["grad_norm"]) > 1.0
    np.testing.assert_allclose(float(got_m["grad_norm"]),
                               float(want_m["grad_norm"]), rtol=1e-5)
    for k in ("m", "v"):
        for leaf in (lambda t: t["final_norm"]["scale"],
                     lambda t: t["blocks"]["attn_norm"]["scale"]):
            want = leaf(want_s[k])
            torch.testing.assert_close(leaf(got_s[k]), want, rtol=1e-5,
                                       atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("case", CASES[:2], ids=lambda c: c[1] or c[0])
def test_collectives_a_step_equal_the_design_count(models, case):
    """TP 2: a step counts the forward's collectives, their backward
    duals and the layers' forward ones again under remat (none again
    without remat); a forward under no_grad counts the serving design's
    (2 L + 2 for a dense model, as the serving steps count)."""
    m = models[case]
    cfg = m["api"].cfg
    for remat in (True, False):
        _, _, _, step = _sharded(m, 1, 2, remat=remat)
        plan = step.plans[0]
        assert plan.collectives == _step_count(cfg, plan, remat)
    mesh = _mesh(1, 2)
    specs = sp.train_specs(m["api"], m["params"], mesh)
    local = sh.local_trees(sh.place(m["params"], specs, mesh), specs, mesh)
    plan = tf.tp_plan(cfg, specs, [CPU] * 2)
    with torch.no_grad():
        tf.tp_forward(local, [m["batch"]["tokens"]] * 2, cfg, plan)
    assert plan.collectives == _forward_count(cfg, plan)
    if cfg.family == "dense":
        assert plan.collectives == 2 * cfg.n_layers + 2


@pytest.mark.parametrize("impl", ["gshard", "gather"])
def test_moe_expert_cut_forward_and_grads_equal_unsharded(impl):
    """The counterpart of the reference's expert-parallel combine wall
    (``test_moe_impls.py::test_gather_under_mesh_uses_shard_map_combine``):
    the MoE sublayer with its experts and router columns cut over two
    positions (each routes on the gathered logits, adds its experts'
    outputs, then the reduce) equals the unsharded layer, forward, aux
    and the gradients of x and every expert weight."""
    cfg = _cfg("deepseek-moe-16b", impl)
    api = build_model(cfg)
    params = api.init(seed=0, device="cpu", dtype=torch.float32)
    mesh = _mesh(1, 2)
    specs = sp.train_specs(api, params, mesh)
    placed = sh.place(params, specs, mesh)
    pieces = [t.requires_grad_(True) for t in tree_leaves(placed)]
    local = sh.local_trees(placed, specs, mesh)
    plan = tf.tp_plan(cfg, specs, [CPU] * 2)
    lp = plan.layers[-1]
    assert lp["experts"] and lp["router"]
    g = torch.Generator()
    g.manual_seed(3)
    x = torch.randn((2, 16, cfg.d_model), generator=g, requires_grad=True)
    w = torch.randn((2, 16, cfg.d_model), generator=g)
    bps = [tf.layer_params(t["blocks"], 0) for t in local]
    outs, means = tf._tp_ffn(bps, [x, x], cfg, plan, lp)
    y = tf._tp_sum(plan, outs)[0]
    aux = moe_lib.balance_loss(means, cfg.moe.n_experts)
    got = torch.autograd.grad((y * w).sum() + aux, [x] + pieces,
                              allow_unused=True)
    got = [torch.zeros_like(t) if g is None else g
           for g, t in zip(got, [x] + pieces)]

    whole = tf.layer_params(params["blocks"], 0)["moe"]
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in whole.items() if torch.is_tensor(v)}
    xr = x.detach().clone().requires_grad_(True)
    yr, auxr = moe_lib.apply_moe({**whole, **leaves}, xr, cfg)
    want = torch.autograd.grad((yr * w).sum() + auxr,
                               [xr] + list(leaves.values()))
    torch.testing.assert_close(y, yr, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(aux, auxr, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    it = iter(got[1:])
    grads = sh.unshard(sh._zip_map(lambda p, _: [next(it) for _ in p],
                                   placed, specs), specs, mesh)
    moe_grads = grads["blocks"]["moe"]
    for k, gw in zip(leaves, want[1:]):
        torch.testing.assert_close(moe_grads[k][0], gw, rtol=1e-5,
                                   atol=1e-6, msg=k)


def test_place_local_trees_and_unshard():
    """Pieces store each element once, on the first position that holds
    them; local trees gather "data" cuts and keep "model" cuts; unshard
    gives the tree back; a cut over "model" jointly with "data"
    (fsdp_flat) is gathered only whole, in row-major order of the two
    axes, and is refused for a tensor-parallel local tree."""
    mesh = _mesh(2, 2)
    tree = {"a": torch.arange(24.).reshape(2, 3, 4),
            "b": [torch.arange(8.).reshape(2, 4)], "c": torch.ones(3)}
    specs = {"a": sh.P(None, None, "model"), "b": [sh.P("data", "model")],
             "c": sh.P(None)}
    placed = sh.place(tree, specs, mesh)
    assert [len(placed["a"]), len(placed["b"][0]), len(placed["c"])] == \
        [2, 4, 1]
    unshard = sh.unshard(placed, specs, mesh)
    for a, b in zip(sh.leaves(unshard), sh.leaves(tree)):
        assert torch.equal(a, b)
    local = sh.local_trees(placed, specs, mesh)
    assert torch.equal(local[3]["b"][0], tree["b"][0][:, 2:])
    assert torch.equal(local[2]["a"], tree["a"][..., :2])
    assert local[1]["c"] is placed["c"][0]
    half = sh.local_trees(placed, specs, mesh, dtype=torch.bfloat16)
    assert half[0]["b"][0].dtype == torch.bfloat16
    joint = {**specs, "a": sh.P(None, None, ("data", "model"))}
    placed = sh.place(tree, joint, mesh)
    assert torch.equal(placed["a"][1], tree["a"][..., 1:2])
    for local in sh.local_trees(placed, joint, mesh, whole=True):
        for a, b in zip(sh.leaves(local), sh.leaves(tree)):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="whole"):
        sh.local_trees(placed, joint, mesh)


def test_remat_over_several_devices_is_refused(models):
    """Per-layer remat over positions, once refused on several devices,
    is one autograd node a layer (``transformer.remat_node``) whose
    inputs are the layer's weights and activations on every position and
    whose backward recomputes the layer once: at TP 2 in float32 the
    logits and every piece's gradient equal those of ``remat=False``, and
    the collectives count the layers' forward ones once again, no more."""
    m = models["gemma-7b", None]
    cfg = m["api"].cfg
    mesh = _mesh(1, 2)
    specs = sp.train_specs(m["api"], m["params"], mesh)
    placed = sh.place(m["params"], specs, mesh)
    got = {}
    for remat in (False, True):
        pieces = [t.detach().clone().requires_grad_(True)
                  for t in tree_leaves(placed)]
        it = iter(pieces)
        local = sh.local_trees(sh._zip_map(lambda p, _: [next(it) for _ in p],
                                           placed, specs), specs, mesh)
        plan = tf.tp_plan(cfg, specs, [CPU] * 2)
        logits, _ = tf.tp_forward(local, [m["batch"]["tokens"]] * 2, cfg,
                                  plan, compute_dtype=torch.float32,
                                  remat=remat)
        grads = torch.autograd.grad((logits * logits).mean(), pieces)
        got[remat] = (logits.detach(), grads, plan.collectives)
    torch.testing.assert_close(got[True][0], got[False][0], rtol=0, atol=0)
    for a, b in zip(got[True][1], got[False][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    assert got[True][2] == got[False][2] + 2 * cfg.n_layers
