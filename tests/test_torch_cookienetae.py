"""The port's CookieNetAE and CookieBox shots against the reference's, on
the CPU in float32, and CookieNetAE's DNNTrainerFlow on ``repro_torch.core``.

Parameters come from the reference's ``init`` and are converted with
``paper_model_from_reference_params``; inputs are made with numpy from a
seed and fed to both packages.  Tolerances (float32 convolutions summed
in other orders):

* the forward at the published width, as a relative 2-norm of the whole
  output and element by element, at 1e-5;
* the loss at ``rtol = 1e-5``; each gradient as a relative 2-norm at
  1e-4 and element by element within 1e-3 of the leaf's largest |grad|,
  but the head's bias, whose gradient is zero but for rounding (the
  softmax ignores a shift), within 1e-4 of the largest |grad| of all;
* one ``adam(1e-3)`` update from identical gradients and state at float32
  rounding (``rtol = 1e-5, atol = 1e-7``);
* the shots' pdf on the reference's own draws at ``atol = 1e-6``.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import CookieNetAEConfig
from repro_torch.data.synthetic import cookiebox_pdf, cookiebox_shots
from repro_torch.models import cookienetae as tc
from repro_torch.models.convert import paper_model_from_reference_params
from repro_torch.optim import adam
from repro_torch.train import make_train_step

CFG = CookieNetAEConfig()
# the 1x1 head's bias: a shift of the softmax's input along the bins,
# whose gradient is zero in exact arithmetic
SHIFT_BIAS = "conv7_b"


@pytest.fixture(scope="module")
def jax_side():
    """The reference package's CookieNetAE, data and optimizers."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro import optim as joptim
    from repro.data import synthetic as jsyn
    from repro.models import cookienetae as jc
    return dict(jax=jax, jnp=jnp, model=jc, optim=joptim, synthetic=jsyn)


def _np_tree(jax, tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _params(side, seed=0):
    """The reference's CookieNetAE init as (jax tree, port dict)."""
    jp = side["model"].init_params(side["jax"].random.PRNGKey(seed), CFG)
    return jp, paper_model_from_reference_params(_np_tree(side["jax"], jp),
                                                 device="cpu")


def _batch(seed, n=4):
    """Numpy CookieBox-like shots: per-channel histograms (rows summing
    to 1) and smooth pdf targets, (n, 16, 128, 1) float32."""
    rng = np.random.default_rng(seed)
    x = np.arange(CFG.bins, dtype=np.float32)
    mu = rng.uniform(20, 108, (n, CFG.channels, 1))
    pdf = np.exp(-(x - mu) ** 2 / (2 * rng.uniform(2, 6, mu.shape) ** 2))
    pdf = (pdf / pdf.sum(-1, keepdims=True)).astype(np.float32)
    counts = rng.poisson(200 * pdf).astype(np.float32)
    hist = counts / np.maximum(counts.sum(-1, keepdims=True), 1.0)
    return {"images": hist[..., None].astype(np.float32),
            "targets": pdf[..., None]}


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_parameter_count_and_init_match_reference(jax_side):
    """337,153 parameters with the reference's names and shapes (conv
    weights OIHW); the port's own init draws the reference's
    distribution: zero biases, weights a normal truncated at +-2 std of
    std 1/sqrt(kh kw cin)."""
    from repro.models.common import count_params
    jp, conv = _params(jax_side)
    tp = tc.init_params(CFG, seed=0, device="cpu")
    assert count_params(jp) == tc.N_PARAMS == 337_153
    assert sum(v.numel() for v in tp.values()) == tc.N_PARAMS
    assert {k: tuple(v.shape) for k, v in tp.items()} == {
        k: tuple(v.shape) for k, v in conv.items()}
    for k, v in tp.items():
        assert v.dtype == torch.float32
        if k.endswith("_b"):
            assert not bool(v.any())
            continue
        std = v.shape[1] * v.shape[2] * v.shape[3]
        std = std ** -0.5
        assert float(v.abs().max()) <= 2 * std * (1 + 1e-6), k
        ref = float(np.std(np.asarray(jp[k])))
        assert float(v.std()) == pytest.approx(ref, rel=0.35), k
    assert torch.equal(tc.init_params(CFG, seed=0, device="cpu")["conv3_w"],
                       tp["conv3_w"])


def test_forward_matches_reference(jax_side):
    """The forward at the published width (batch 4): the NHWC boundary,
    "SAME" padding, ReLU after every layer but the last, and the softmax
    over the energy bins."""
    jnp = jax_side["jnp"]
    jp, tp = _params(jax_side)
    b = _batch(0)
    want = np.asarray(jax_side["model"].forward(jp, jnp.asarray(b["images"]),
                                                CFG))
    got = tc.forward(tp, torch.from_numpy(b["images"]), CFG).numpy()
    assert got.shape == want.shape == (4, 16, 128, 1)
    assert _rel_l2(got, want) <= 1e-5
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(got[..., 0].sum(-1), 1.0, atol=1e-5)


def test_loss_and_gradients_match_reference(jax_side):
    """The MSE and its gradient with respect to every parameter, against
    ``jax.grad`` of the reference's ``loss_fn``."""
    jax, jnp = jax_side["jax"], jax_side["jnp"]
    jc = jax_side["model"]
    jp, tp = _params(jax_side, seed=1)
    b = _batch(1)
    jbatch = {k: jnp.asarray(v) for k, v in b.items()}
    (wl, wm), jg = jax.value_and_grad(lambda p: jc.loss_fn(p, jbatch, CFG),
                                      has_aux=True)(jp)
    want = {k: v.numpy() for k, v in paper_model_from_reference_params(
        _np_tree(jax, jg), device="cpu").items()}
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    loss, metrics = tc.loss_fn(leaves, _torch(b), CFG)
    np.testing.assert_allclose(loss.item(), float(wl), rtol=1e-5)
    np.testing.assert_allclose(metrics["mse"].item(), float(wm["mse"]),
                               rtol=1e-5)
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    assert set(grads) == set(want)
    scale = max(np.abs(w).max() for w in want.values())
    for k, g in grads.items():
        g = g.numpy()
        if k == SHIFT_BIAS:
            # the softmax ignores a shift of its input: zero up to rounding
            assert np.abs(g).max() <= 1e-4 * scale
            assert np.abs(want[k]).max() <= 1e-4 * scale
            continue
        assert _rel_l2(g, want[k]) <= 1e-4, k
        np.testing.assert_allclose(g, want[k], rtol=0,
                                   atol=1e-3 * np.abs(want[k]).max(),
                                   err_msg=k)


def test_one_adam_update_matches_reference(jax_side):
    """One ``adam(1e-3)`` update of the CookieNetAE tree from the same
    gradients (the reference's, of a batch's loss) and a fresh state."""
    jax, jnp = jax_side["jax"], jax_side["jnp"]
    jc = jax_side["model"]
    jp, tp = _params(jax_side, seed=2)
    jbatch = {k: jnp.asarray(v) for k, v in _batch(2).items()}
    jg = jax.grad(lambda p: jc.loss_fn(p, jbatch, CFG)[0])(jp)
    tg = paper_model_from_reference_params(_np_tree(jax, jg), device="cpu")
    jopt, topt = jax_side["optim"].adam(1e-3), adam(1e-3)
    want_p, want_s = jopt.update(jg, jopt.init(jp), jp)
    got_p, got_s = topt.update(tg, topt.init(tp), tp)
    want_p = paper_model_from_reference_params(_np_tree(jax, want_p),
                                               device="cpu")
    for k, v in got_p.items():
        np.testing.assert_allclose(v.numpy(), want_p[k].numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
        assert not torch.equal(v, tp[k]), k
    assert int(got_s["step"]) == int(want_s["step"]) == 1


def test_twenty_steps_lower_the_loss():
    """The reference test's gate (tests/test_paper_models.py): 20
    ``adam(1e-3)`` steps on one batch of 16 shots bring the loss to at most
    0.8 of the first."""
    g = torch.Generator().manual_seed(0)
    d = cookiebox_shots(g, 16, device="cpu")
    params = tc.init_params(CFG, seed=0, device="cpu")
    step = make_train_step(lambda p, b: tc.loss_fn(p, b, CFG), adam(1e-3))
    state = adam(1e-3).init(params)
    losses = []
    for _ in range(20):
        params, state, m = step(params, state, d)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] <= 0.8 * losses[0]


def test_cookiebox_pdf_matches_reference_targets(jax_side):
    """The port's deterministic pdf on the reference's own draws (the
    same ``jax.random.split`` of the key, in the reference's order)
    equals the reference's ``cookiebox_shots`` targets."""
    jax, jnp = jax_side["jax"], jax_side["jnp"]
    key, n, bins = jax.random.PRNGKey(5), 64, CFG.bins
    want = np.asarray(jax_side["synthetic"].cookiebox_shots(key, n)
                      ["targets"])
    k1, k2, k3, k4, _ = jax.random.split(key, 5)
    draws = [jax.random.uniform(k1, (n, 3), minval=10.0, maxval=bins - 10.0),
             jax.random.uniform(k2, (n, 3), minval=2.0, maxval=6.0),
             jax.random.uniform(k3, (n, 3), minval=0.0, maxval=2 * jnp.pi),
             jax.random.uniform(k4, (n, 3), minval=0.2, maxval=1.0)]
    got = cookiebox_pdf(*(torch.from_numpy(np.array(a)) for a in draws),
                        CFG.channels, bins)
    assert got.dtype == torch.float32
    assert tuple(got.shape) + (1,) == want.shape == (n, 16, 128, 1)
    np.testing.assert_allclose(got.numpy(), want[..., 0], rtol=0, atol=1e-6)


@pytest.mark.parametrize("counts", [200, 3])
def test_cookiebox_shots_are_normalized_seeded_poisson_draws(counts):
    """Shapes and dtypes; every target row a pdf and every image row a
    histogram normalized by max(its count, 1) (so it sums to 1, or to 0
    with no count); the same seed gives the same shots and another seed
    others; redrawn from the same generator state, the counts behind the
    images average ``counts`` a row."""
    n = 256
    d = cookiebox_shots(torch.Generator().manual_seed(3), n, counts=counts,
                        device="cpu")
    for k in ("images", "targets"):
        assert d[k].shape == (n, 16, 128, 1) and d[k].dtype == torch.float32
    np.testing.assert_allclose(d["targets"].sum((2, 3)).numpy(), 1.0,
                               atol=1e-5)
    rows = d["images"].sum((2, 3)).numpy()
    assert np.all(np.isclose(rows, 1.0, atol=1e-5) | (rows == 0.0))
    again = cookiebox_shots(torch.Generator().manual_seed(3), n,
                            counts=counts, device="cpu")
    other = cookiebox_shots(torch.Generator().manual_seed(4), n,
                            counts=counts, device="cpu")
    for k in d:
        assert torch.equal(d[k], again[k])
        assert not torch.equal(d[k], other[k])
    # the draws in the module's order: four uniforms, then the counts
    g = torch.Generator().manual_seed(3)
    lo_hi = [(10.0, 118.0), (2.0, 6.0), (0.0, 2 * np.pi), (0.2, 1.0)]
    draws = [lo + (hi - lo) * torch.rand((n, 3), generator=g)
             for lo, hi in lo_hi]
    pdf = cookiebox_pdf(*draws)
    assert torch.equal(pdf, d["targets"][..., 0])
    raw = torch.poisson(counts * pdf, generator=g)
    total = raw.sum(-1, keepdim=True)
    assert torch.equal(raw / torch.clamp(total, min=1.0),
                       d["images"][..., 0])
    assert abs(float(total.mean()) - counts) <= 0.02 * counts
    assert bool((total == 0).any()) == (counts < 10)


def test_cookienetae_flow_matches_the_references_flow(jax_side):
    """``run_cookienetae`` on the port's ``repro_torch.core`` passes the
    reference flow's states, and the same files and artifact moved
    through the reference's ``repro.core`` by ``bench_table1``'s flow
    (the DNNTrainerFlow without LabelData, a real-mode DCAI endpoint) are
    charged the same simulated seconds; the model registers as v1 and its
    training loss falls.  ``main`` gates the fall at COOKIE_LOSS_RATIO
    (``test_torch_paper_loop.py`` runs it)."""
    from repro.core import build_system as jax_build_system
    from repro.core import dnn_trainer_flow as jax_flow
    from repro.core.transfer import FileRef as JaxFileRef
    from repro_torch.launch import remote_retrain_flow as rrf
    lines = []
    res = rrf.run_cookienetae(steps=6, shots=130, device="cpu",
                              log=lines.append)
    run = res["run"]
    assert [e.state for e in run.log] == ["TransferData", "TrainModel",
                                          "TransferModel", "RegisterModel"]
    assert [e.version_tag for e in
            res["system"].repo.versions("cookienetae")] == ["v1"]
    assert res["final_loss"] < res["first_loss"]
    assert res["dataset_bytes"] == 130 * 16 * 128 * 4 * 2
    assert lines[0].startswith("flow cookienetae v1: status=SUCCEEDED")

    # the reference's flow on the same file sizes
    sys_ = jax_build_system()
    per = [f.nbytes for f in (res["system"].store.get("slac", n)
                              for n in (f"cookienetae-{i}.h5"
                                        for i in range(rrf.COOKIE_FILES)))]
    names = [f"cookienetae-{i}.h5" for i in range(rrf.COOKIE_FILES)]
    for name, nbytes in zip(names, per):
        sys_.store.put("slac", JaxFileRef(name, nbytes))

    def train(*_):
        sys_.store.put("alcf", JaxFileRef("cookienetae.pt",
                                          rrf.COOKIE_MODEL_BYTES))
        return {"ok": True}

    fid = sys_.funcx.register_function(train, "cookienetae")
    # the reference has no "h100"; the states compared do not depend on
    # the DCAI device
    eid = sys_.funcx.register_endpoint("cerebras", mode="real")
    want = sys_.flows.run(sys_.flows.deploy(jax_flow()), {
        "src": "slac", "dc": "alcf", "dataset": names,
        "train_endpoint": eid, "train_function": fid,
        "train_args": [], "train_kwargs": {}, "modeled_duration": None,
        "model_artifacts": ["cookienetae.pt"],
        "model_name": "cookienetae.pt", "register_as": "cookienetae",
        "version_tag": "v1", "metrics": {}}, sys_.user_token())
    assert want.status == run.status == "SUCCEEDED"
    got_s, want_s = run.step_seconds(), want.step_seconds()
    assert list(got_s) == list(want_s)
    for state in ("TransferData", "TransferModel", "RegisterModel"):
        assert got_s[state] == pytest.approx(want_s[state], rel=1e-12), state
