"""The port's paper loop (S -> A -> T -> E for BraggNN) against the
reference's, on the CPU in float32.

BraggNN's parameters come from the reference's ``init`` and are converted
with ``paper_model_from_reference_params``; inputs are made with numpy from a
seed and fed to both packages.  Tolerances: forward and loss at
``atol = 1e-5`` and gradients at ``rtol = 1e-4, atol = 1e-6`` (float32
convolutions and matmuls summed in other orders); one optimizer update,
given identical gradients and state, at float32 rounding (``rtol = 1e-5,
atol = 1e-7``), since Adam at step 1 moves a weight by ~lr * sign(g), and a
gradient at rounding level may flip sign between frameworks, so
parameters after many steps are not compared; a 20-step loss curve at
``rtol = 1e-3``.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import BraggNNConfig
from repro_torch.data.pipeline import ShardedLoader, take
from repro_torch.data.synthetic import bragg_patches
from repro_torch.models import braggnn as tb
from repro_torch.models.convert import paper_model_from_reference_params
from repro_torch.optim import adam, global_norm, sgd
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.serving.batch import BatchEngine
from repro_torch.train import TrainerConfig, fit, make_train_step

ROOT = Path(__file__).resolve().parents[1]
CFG = BraggNNConfig()


@pytest.fixture
def jax_side():
    """The reference package's BraggNN, optimizers, trainer and engine."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro import optim as joptim
    from repro.models import braggnn as jb
    from repro.serving.batch import BatchEngine as JaxBatchEngine
    from repro.train import trainer as jtrainer
    return dict(jax=jax, jnp=jnp, braggnn=jb, optim=joptim,
                trainer=jtrainer, BatchEngine=JaxBatchEngine)


def _np_tree(jax, tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _params(side, seed=0):
    """The reference's BraggNN init as (jax pytree, port dict)."""
    jp = side["braggnn"].init_params(side["jax"].random.PRNGKey(seed), CFG)
    tp = paper_model_from_reference_params(_np_tree(side["jax"], jp),
                                           device="cpu")
    return jp, tp


def _batch(seed, n=16):
    """Numpy Bragg-like patches (random noise on a peak) and targets."""
    rng = np.random.default_rng(seed)
    x = rng.random((n, 11, 11, 1), dtype=np.float32)
    yy, xx = np.mgrid[0:11, 0:11].astype(np.float32)
    c = rng.uniform(3.5, 6.5, (n, 2)).astype(np.float32)
    peak = np.exp(-((yy - c[:, 0, None, None]) ** 2
                    + (xx - c[:, 1, None, None]) ** 2) / 2.0)
    x = (0.1 * x + peak[..., None]).astype(np.float32)
    return {"patches": x, "centers": (c / 10).astype(np.float32)}


def _to_port(jax, tree_np):
    """A reference BraggNN tree (params or grads) in the port's layout."""
    return {k: v.numpy() for k, v in paper_model_from_reference_params(
        _np_tree(jax, tree_np), device="cpu").items()}


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def test_forward_and_loss_match_reference(jax_side):
    jnp = jax_side["jnp"]
    jb = jax_side["braggnn"]
    jp, tp = _params(jax_side)
    b = _batch(0)
    want = np.asarray(jb.forward(jp, jnp.asarray(b["patches"]), CFG))
    got = tb.forward(tp, torch.from_numpy(b["patches"]), CFG)
    assert got.shape == (16, 2)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    wl, wm = jb.loss_fn(jp, {k: jnp.asarray(v) for k, v in b.items()}, CFG)
    gl, gm = tb.loss_fn(tp, _torch(b), CFG)
    np.testing.assert_allclose(float(gl), float(wl), atol=1e-5)
    np.testing.assert_allclose(float(gm["mse"]), float(wm["mse"]), atol=1e-5)


def test_gradients_match_reference(jax_side):
    jax, jnp = jax_side["jax"], jax_side["jnp"]
    jb = jax_side["braggnn"]
    jp, tp = _params(jax_side, seed=1)
    b = _batch(1)
    jbatch = {k: jnp.asarray(v) for k, v in b.items()}
    want = _to_port(jax, jax.grad(
        lambda p: jb.loss_fn(p, jbatch, CFG)[0])(jp))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    loss, _ = tb.loss_fn(leaves, _torch(b), CFG)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert set(want) == set(leaves)
    for (k, _), g in zip(leaves.items(), grads):
        np.testing.assert_allclose(g.numpy(), want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def _opt_inputs(rng):
    """A nested parameter tree with 1-, 2- and 4-D leaves and its
    gradients, in numpy (the same layout on both sides)."""
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    params = {"w": f(5, 7), "b": f(7), "blk": {"conv": f(3, 3, 2, 4)}}
    grads = {"w": f(5, 7), "b": f(7), "blk": {"conv": f(3, 3, 2, 4)}}
    return params, grads


def _state(name, params, rng):
    """A mid-training optimizer state (step 3) with random moments."""
    def tmap(fn, t):
        return ({k: tmap(fn, v) for k, v in t.items()}
                if isinstance(t, dict) else fn(t))
    pos = lambda a: rng.uniform(0.01, 1.0, a.shape).astype(np.float32)
    sym = lambda a: rng.standard_normal(a.shape).astype(np.float32)
    step = np.int32(3)
    if name == "sgd_nesterov":
        return {"step": step, "mu": tmap(sym, params)}
    if name == "adafactor":
        def slot(a):
            if a.ndim >= 2:
                return {"vr": pos(np.zeros(a.shape[:-1])),
                        "vc": pos(np.zeros(a.shape[:-2] + a.shape[-1:]))}
            return {"v": pos(a)}
        return {"step": step, "slots": tmap(slot, params)}
    return {"step": step, "m": tmap(sym, params), "v": tmap(pos, params)}


OPTIMIZERS = {
    "adam": lambda o: o.adam(1e-3),
    "adamw_decay_clip": lambda o: o.adamw(1e-3, weight_decay=0.1,
                                          grad_clip_norm=0.5),
    "sgd_nesterov": lambda o: o.sgd(1e-2, momentum=0.9, nesterov=True),
    "adafactor": lambda o: o.adafactor(1e-2),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_one_update_matches_reference(jax_side, name):
    """One update of each optimizer, given identical gradients and state,
    equals the reference's; so does ``init``'s structure."""
    import repro_torch.optim as toptim
    jax, jnp = jax_side["jax"], jax_side["jnp"]
    rng = np.random.default_rng(7)
    params, grads = _opt_inputs(rng)
    state = _state(name, params, rng)
    jopt = OPTIMIZERS[name](jax_side["optim"])
    topt = OPTIMIZERS[name](toptim)
    to_j = lambda t: jax.tree.map(jnp.asarray, t)
    to_t = lambda t: jax.tree.map(lambda a: torch.from_numpy(np.array(a)), t)
    want_p, want_s = jopt.update(to_j(grads), to_j(state), to_j(params))
    got_p, got_s = topt.update(to_t(grads), to_t(state), to_t(params))
    want_p, want_s = _np_tree(jax, want_p), _np_tree(jax, want_s)
    got_p = jax.tree.map(lambda t: t.numpy(), got_p)
    got_s = jax.tree.map(lambda t: t.numpy(), got_s)
    assert jax.tree.structure(got_p) == jax.tree.structure(want_p)
    assert jax.tree.structure(got_s) == jax.tree.structure(want_s)
    for g, w in zip(jax.tree.leaves(got_p) + jax.tree.leaves(got_s),
                    jax.tree.leaves(want_p) + jax.tree.leaves(want_s)):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7)
    init_j = jax.tree.map(np.shape, _np_tree(jax, jopt.init(to_j(params))))
    init_t = jax.tree.map(lambda t: tuple(t.shape),
                          topt.init(to_t(params)))
    assert init_t == init_j
    assert float(global_norm(to_t(grads))) == pytest.approx(
        float(jax_side["optim"].global_norm(to_j(grads))), rel=1e-6)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_matches_reference(jax_side, grad_accum):
    """``make_train_step`` (microbatched with grad_accum = 2) against the
    reference's: metrics, and the parameters after one SGD step (linear in
    the gradients, so rounding cannot flip a step's sign)."""
    jax, jnp = jax_side["jax"], jax_side["jnp"]
    jb = jax_side["braggnn"]
    jp, tp = _params(jax_side, seed=2)
    b = _batch(2, n=8)
    jstep = jax_side["trainer"].make_train_step(
        lambda p, bb: jb.loss_fn(p, bb, CFG), jax_side["optim"].sgd(1e-2),
        grad_accum=grad_accum, donate=False)
    tstep = make_train_step(lambda p, bb: tb.loss_fn(p, bb, CFG),
                            sgd(1e-2), grad_accum=grad_accum)
    jopt = jax_side["optim"].sgd(1e-2)
    wp, _, wm = jstep(jp, jopt.init(jp), {k: jnp.asarray(v)
                                          for k, v in b.items()})
    gp, gs, gm = tstep(tp, sgd(1e-2).init(tp), _torch(b))
    assert set(gm) == set(wm) == {"loss", "mse", "grad_norm"}
    for k in wm:
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    want = _to_port(jax, wp)
    for k, v in gp.items():
        assert not v.requires_grad
        np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert int(gs["step"]) == 1


def test_fit_loss_curve_matches_reference(jax_side):
    """20 Adam steps of ``fit`` on identical batches: the loss curves
    agree at rtol 1e-3; the history has the reference's layout."""
    jax, jnp = jax_side["jax"], jax_side["jnp"]
    jb = jax_side["braggnn"]
    jp, tp = _params(jax_side, seed=3)
    batches = [_batch(100 + i) for i in range(20)]
    cfg_j = jax_side["trainer"].TrainerConfig(steps=20, log_every=1)
    _, jh = jax_side["trainer"].fit(
        lambda p, bb: jb.loss_fn(p, bb, CFG), jax_side["optim"].adam(1e-3),
        jp, iter([{k: jnp.asarray(v) for k, v in bb.items()}
                  for bb in batches]), cfg_j)
    state, th = fit(lambda p, bb: tb.loss_fn(p, bb, CFG), adam(1e-3), tp,
                    iter([_torch(bb) for bb in batches]),
                    TrainerConfig(steps=20, log_every=1))
    assert [s for s, _ in th["loss"]] == [s for s, _ in jh["loss"]] == list(
        range(1, 21))
    np.testing.assert_allclose([v for _, v in th["loss"]],
                               [v for _, v in jh["loss"]], rtol=1e-3)
    assert th["loss"][-1][1] < th["loss"][0][1]
    assert len(th["step_time"]) == 20 and th["wall_time"] > 0
    assert state.step == 20 and int(state.opt_state["step"]) == 20


def test_fit_logs_like_reference_and_refuses_checkpoints(tmp_path):
    """fit logs at the reference's steps; with a ckpt_dir it checkpoints
    every ckpt_every steps and at the end, as the reference does (it
    refused a ckpt_dir until checkpointing was ported)."""
    from repro_torch.train import checkpoint as ck
    tp = tb.init_params(CFG, seed=0, device="cpu")
    batches = iter([_torch(_batch(i, n=4)) for i in range(10)])
    seen = []
    _, h = fit(lambda p, bb: tb.loss_fn(p, bb, CFG), adam(1e-3), tp,
               batches, TrainerConfig(steps=7, log_every=3),
               callbacks=[lambda s, m: seen.append(s)])
    assert [s for s, _ in h["loss"]] == seen == [1, 3, 6, 7]
    state, _ = fit(lambda p, bb: tb.loss_fn(p, bb, CFG), adam(1e-3), tp,
                   batches, TrainerConfig(steps=3, ckpt_dir=str(tmp_path),
                                          ckpt_every=2))
    assert sorted(f for f in os.listdir(tmp_path) if f.endswith(".json")) \
        == ["ckpt_00000002.json", "ckpt_00000003.json"]
    restored, manifest = ck.restore_checkpoint(
        str(tmp_path), {"params": tp, "opt_state": state.opt_state})
    assert manifest["step"] == 3
    for k, v in state.params.items():
        assert torch.equal(restored["params"][k], v)


def test_init_params_matches_reference_shapes_and_scales(jax_side):
    jp, conv = _params(jax_side)
    tp = tb.init_params(CFG, seed=0, device="cpu")
    assert {k: tuple(v.shape) for k, v in tp.items()} == {
        k: tuple(v.shape) for k, v in conv.items()}
    for k, v in tp.items():
        assert v.dtype == torch.float32
        if k.endswith("_b"):
            assert not bool(v.any())
        else:
            ref_std = float(np.std(np.asarray(jp[k])))
            assert float(v.std()) == pytest.approx(ref_std, rel=0.35), k
    assert torch.equal(tb.init_params(CFG, seed=0, device="cpu")["fc0_w"],
                       tp["fc0_w"])


def test_batch_engine_matches_reference(jax_side):
    """Padding, outputs and counters of the edge engine on an odd-sized
    request (37 rows at max_batch 16: chunks of 16, 16 and 5, the last
    padded to 8)."""
    jb = jax_side["braggnn"]
    jp, tp = _params(jax_side, seed=4)
    x = _batch(4, n=37)["patches"]
    jeng = jax_side["BatchEngine"](lambda p, xx: jb.forward(p, xx, CFG), jp,
                                   max_batch=16)
    seen = []

    def apply(p, xx):
        seen.append(tuple(xx.shape))
        assert not torch.is_grad_enabled()
        return tb.forward(p, xx, CFG)

    teng = BatchEngine(apply, tp, max_batch=16, device="cpu")
    want = jeng.infer(x)
    got = teng.infer(x)
    assert isinstance(got, np.ndarray) and got.shape == (37, 2)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert seen == [(16, 11, 11, 1), (16, 11, 11, 1), (8, 11, 11, 1)]
    got1 = teng.infer(x[:3])
    np.testing.assert_allclose(got1, jeng.infer(x[:3]), atol=1e-5)
    assert seen[-1] == (4, 11, 11, 1)
    ws, gs = jeng.stats.summary(), teng.stats.summary()
    assert set(ws) == set(gs)
    assert {k: gs[k] for k in ("requests", "batches", "items")} == {
        k: ws[k] for k in ("requests", "batches", "items")} == {
        "requests": 2, "batches": 4, "items": 40}
    assert gs["mean_latency_s"] > 0


def test_sharded_loader_is_deterministic_and_shards_by_host():
    """Step k's batch depends on (seed, k) only; hosts take disjoint
    slices of the same global batch; prefetch changes nothing."""
    def make(g, bs):
        d = bragg_patches(g, bs, device="cpu")
        return {"patches": d["patches"], "meta": {"centers": d["centers"]}}

    full = take(ShardedLoader(make, 8, seed=5, prefetch=0, device="cpu"), 3)
    again = take(ShardedLoader(make, 8, seed=5, prefetch=2, device="cpu"), 3)
    other = take(ShardedLoader(make, 8, seed=6, prefetch=0, device="cpu"), 1)
    for a, b in zip(full, again):
        assert torch.equal(a["patches"], b["patches"])
        assert torch.equal(a["meta"]["centers"], b["meta"]["centers"])
    assert not torch.equal(full[0]["patches"], full[1]["patches"])
    assert not torch.equal(full[0]["patches"], other[0]["patches"])
    halves = [take(ShardedLoader(make, 8, seed=5, host_id=h, host_count=2,
                                 prefetch=0, device="cpu"), 2)
              for h in range(2)]
    for step in range(2):
        parts = [halves[h][step]["patches"] for h in range(2)]
        assert parts[0].shape[0] == 4
        assert torch.equal(torch.cat(parts), full[step]["patches"])
    with pytest.raises(ValueError, match="split"):
        ShardedLoader(make, 9, host_count=2, device="cpu")

    def broken(g, bs):
        raise RuntimeError("make_batch failed")

    with pytest.raises(RuntimeError, match="make_batch failed"):
        take(ShardedLoader(broken, 4, prefetch=2, device="cpu"), 1)


def test_entry_points_default_to_the_card():
    """Without CUDA, the paper loop's entry points refuse the default
    device instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        tb.init_params(CFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        bragg_patches(torch.Generator(), 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedLoader(lambda g, bs: {}, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchEngine(lambda p, x: x, {})


def test_quickstart_runs_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.quickstart", "--device",
         "cpu"], cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"),
                                "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "quickstart OK" in out.stdout
    assert "step  150 loss" in out.stdout


def test_remote_retrain_flow_runs_on_cpu():
    """The twin of ``examples/remote_retrain_flow.py`` on the port's own
    ``repro_torch.core``: two DNNTrainerFlow runs with labeling (the second
    warm-started from the repository), A||T over 8 shards, edge serving,
    then CookieNetAE's flow without labeling."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.remote_retrain_flow",
         "--device", "cpu", "--steps", "20", "--peaks", "2048"], cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert lines[-1] == "remote_retrain_flow OK"
    assert "flow v1: status=SUCCEEDED" in out.stdout
    assert "flow v2: status=SUCCEEDED" in out.stdout
    assert "A||T over 8 shards" in out.stdout
    assert "flow cookienetae v1: status=SUCCEEDED" in out.stdout
    assert sum(line.strip().startswith("LabelData") for line in lines) == 2


@pytest.mark.parametrize("core", ["repro.core", "repro_torch.core"])
def test_port_trains_braggnn_inside_the_papers_workflow(core):
    """The paper's DNNTrainerFlow (the unchanged ``repro.core``, and the
    port's own copy) with the port doing T: the edge labels new data
    through the port's A op, the flow ships it to the data center, the
    registered port function trains BraggNN there, and the model comes
    back to the edge repository."""
    if core == "repro.core":
        pytest.importorskip("jax")
    import importlib
    build_system = importlib.import_module(core).build_system
    dnn_trainer_flow = importlib.import_module(core).dnn_trainer_flow
    FileRef = importlib.import_module(f"{core}.transfer").FileRef
    from repro_torch.analysis import label_for_braggnn

    sys_ = build_system()
    tok = sys_.user_token()
    d = bragg_patches(torch.Generator().manual_seed(42), 256, device="cpu")
    labels = label_for_braggnn(d["patches"])
    sys_.store.put("slac", FileRef(
        "new_scan.h5", d["patches"].numel() * 4,
        payload={"patches": d["patches"], "labels": labels}))

    def train_braggnn(dataset_name, steps=12):
        raw = sys_.store.get("alcf", dataset_name).payload
        step = make_train_step(lambda p, bb: tb.loss_fn(p, bb, CFG),
                               adam(1e-3))
        params = tb.init_params(CFG, seed=0, device="cpu")
        opt_state = adam(1e-3).init(params)
        losses = []
        for i in range(steps):
            lo = (i * 32) % (raw["patches"].shape[0] - 32)
            params, opt_state, m = step(params, opt_state, {
                "patches": raw["patches"][lo:lo + 32],
                "centers": raw["labels"][lo:lo + 32]})
            losses.append(float(m["loss"]))
        sys_.store.put("alcf", FileRef("braggnn.pt", 3_000_000,
                                       payload=params))
        return {"first_loss": losses[0], "final_loss": losses[-1]}

    fid = sys_.funcx.register_function(train_braggnn, "train_braggnn_torch")
    eid = sys_.funcx.register_endpoint("gpu-server-8xv100", mode="real")
    flow = sys_.flows.deploy(dnn_trainer_flow())
    run = sys_.flows.run(flow, {
        "src": "slac", "dc": "alcf", "dataset": ["new_scan.h5"],
        "train_endpoint": eid, "train_function": fid,
        "train_args": ["new_scan.h5"], "train_kwargs": {},
        "modeled_duration": None, "model_artifacts": ["braggnn.pt"],
        "model_name": "braggnn.pt", "register_as": "braggnn",
        "version_tag": "torch-v1", "metrics": {},
    }, tok)
    assert run.status == "SUCCEEDED", [e.error for e in run.log]
    res = run.output["TrainModel"]["result"]
    assert np.isfinite(res["final_loss"])
    assert res["final_loss"] < res["first_loss"]
    model = sys_.repo.latest("braggnn").artifact.payload
    assert set(model) == set(tb.init_params(CFG, device="cpu"))
    assert all(isinstance(v, torch.Tensor) for v in tree_leaves(model))
    eng = BatchEngine(lambda p, x: tb.forward(p, x, CFG), model,
                      device="cpu")
    pred = eng.infer(d["patches"][:10].numpy())
    assert pred.shape == (10, 2) and np.isfinite(pred).all()
