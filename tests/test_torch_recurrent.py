"""The port's recurrent families (zamba2: Mamba2 + shared attention; xLSTM:
mLSTM + sLSTM) against the reference's, on the smoke configs on the CPU:
parameters converted from the reference's ``init``, tokens made with
numpy from a seed.

In float32 the forward logits, a run of ``decode_step`` logits and the
prefill step's logits agree to ``ATOL = RTOL = 1e-4`` (two float32
stacks contracting in other orders: readings of a few 1e-6), and the
slot engine's greedy tokens equal the reference engine's, with more
requests than slots so lanes are reused (the recurrent families keep a
reused lane's state and position, as the reference does).  The port's
own decode-vs-forward consistency mirrors
``tests/test_decode_consistency.py`` at its tolerance (2e-2).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.shapes import smoke_shape as jax_smoke_shape
from repro.launch import specs as jax_specs
from repro.models import build_model as jax_build_model
from repro.serving.engine import SlotDecodeEngine as JaxSlotEngine
from repro_torch.configs import get_config
from repro_torch.configs.shapes import smoke_shape
from repro_torch.launch import specs
from repro_torch.models.api import build_model
from repro_torch.models.common import keeps_float32
from repro_torch.models.convert import from_reference_params
from repro_torch.serving.engine import DecodeEngine, SlotDecodeEngine

ATOL = RTOL = 1e-4
# the bf16 prefill steps of the two packages: bf16 matmuls accumulate and
# round in other places on the two sides, so their last-position logits
# differ by about as much as either differs from the float32 forward
# (readings over three token seeds: relative 2-norm 1.1e-2 to 1.4e-2
# between the packages, 1.2e-2 to 1.8e-2 from float32; max |diff| 0.049
# at |logit| <= 3.3).  Gate: twice the readings
BF16_REL_L2 = 3e-2
BF16_MAX_ABS = 0.1
ARCHS = ["zamba2-2.7b", "xlstm-1.3b"]
F32 = dict(device="cpu", dtype=torch.float32)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    japi = jax_build_model(jax_get_config(arch).smoke_variant())
    # jitted: half the time of the eager init (the bits differ from it)
    jparams = jax.jit(japi.init)(jax.random.PRNGKey(0))
    tparams = from_reference_params(jax.tree.map(np.asarray, jparams),
                                    **F32)
    api = build_model(get_config(arch).smoke_variant())
    return arch, japi, jparams, api, tparams


def _tokens(vocab, B, S, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def test_configs_match_reference():
    """The port's config copies equal the reference's, full and smoke."""
    for arch in ARCHS:
        for smoke in (False, True):
            j, t = jax_get_config(arch), get_config(arch)
            if smoke:
                j, t = j.smoke_variant(), t.smoke_variant()
            assert dataclasses.asdict(t) == dataclasses.asdict(j), (arch,
                                                                    smoke)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_match_reference_tree(arch):
    """The port's own init makes the reference's tree (the stacked
    segment layout): the same keys and shapes, weights in the compute
    dtype, norms and the gate and decay parameters in float32; the
    reference's distributions (dt in [1e-3, 1e-1], A in [1, 16], the
    forget-gate biases linspace(3, 6))."""
    jcfg = jax_get_config(arch).smoke_variant()
    jtree = jax.eval_shape(lambda: jax_build_model(jcfg).init(
        jax.random.PRNGKey(0)))
    tparams = build_model(get_config(arch).smoke_variant()).init(
        seed=0, device="cpu", dtype=torch.bfloat16)
    jflat = {jax.tree_util.keystr(k): v.shape for k, v in
             jax.tree_util.tree_flatten_with_path(jtree)[0]}
    tflat = {jax.tree_util.keystr(k): v for k, v in
             jax.tree_util.tree_flatten_with_path(tparams)[0]}
    assert set(jflat) == set(tflat)
    for k, shape in jflat.items():
        assert tuple(tflat[k].shape) == tuple(shape), k
        keys = k.strip("[]'").split("']['")
        want = (torch.float32 if any(keeps_float32(x) for x in keys)
                else torch.bfloat16)
        assert tflat[k].dtype == want, k
    if arch == "zamba2-2.7b":
        m = tparams["segments"]["mamba"]
        dt = torch.nn.functional.softplus(m["dt_bias"])
        assert 1e-3 <= dt.min() and dt.max() <= 1e-1
        a = torch.exp(m["A_log"])
        assert 1.0 <= a.min() and a.max() <= 16.0
    else:
        b_f = tparams["mlstm"]["b_f"]
        assert torch.allclose(b_f[0, 0], torch.linspace(3.0, 6.0,
                                                        b_f.shape[-1]))


def test_forward_matches_reference(model):
    """forward logits in float32 (zamba2's shared attention and both
    scans on their plain paths), over a sequence of two SSD chunks."""
    arch, japi, jparams, api, tparams = model
    toks = _tokens(api.cfg.vocab_size, 2, 64, seed=1)
    want, _ = japi.forward(jparams, jnp.asarray(toks),
                           compute_dtype=jnp.float32, remat=False)
    got, aux = api.forward(tparams, torch.from_numpy(toks),
                           compute_dtype=torch.float32, remat=False)
    assert got.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_decode_steps_match_reference(model):
    """A run of decode_step logits from a fresh cache, in float32, and
    the recurrent states it leaves."""
    arch, japi, jparams, api, tparams = model
    B, S = 2, 12
    toks = _tokens(api.cfg.vocab_size, B, S, seed=2)
    jcache = japi.init_cache(B, S, dtype=jnp.float32)
    cache = api.init_cache(B, S, dtype=torch.float32, device="cpu")
    jstep = jax.jit(lambda p, c, t: japi.decode_step(
        p, c, t, compute_dtype=jnp.float32))
    for t in range(S):
        jl, jcache = jstep(jparams, jcache, jnp.asarray(toks[:, t:t + 1]))
        tl, cache = api.decode_step(tparams, cache,
                                    torch.from_numpy(toks[:, t:t + 1]),
                                    compute_dtype=torch.float32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=RTOL)
    jflat = jax.tree_util.tree_flatten_with_path(jcache)[0]
    tflat = dict((jax.tree_util.keystr(k), v) for k, v in
                 jax.tree_util.tree_flatten_with_path(cache)[0])
    assert len(jflat) == len(tflat)
    for k, v in jflat:
        got = tflat[jax.tree_util.keystr(k)]
        assert str(got.dtype).split(".")[-1] == str(v.dtype), k
        np.testing.assert_allclose(got.numpy(), np.asarray(v), atol=ATOL,
                                   rtol=RTOL, err_msg=str(k))


def test_decode_matches_forward(model):
    """The port's own two paths: feeding tokens one by one through
    decode_step reproduces the chunked forward's logits
    (tests/test_decode_consistency.py, at its tolerance)."""
    arch, _, _, api, tparams = model
    B, S = 2, 16
    toks = torch.from_numpy(_tokens(api.cfg.vocab_size, B, S, seed=3))
    fwd, _ = api.forward(tparams, toks, compute_dtype=torch.float32,
                         remat=False)
    cache = api.init_cache(B, S, dtype=torch.float32, device="cpu")
    outs = []
    for t in range(S):
        logits, cache = api.decode_step(tparams, cache, toks[:, t:t + 1],
                                        compute_dtype=torch.float32)
        outs.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), fwd.numpy(),
                               atol=2e-2, rtol=2e-2)


def test_prefill_step_matches_reference(model):
    """make_prefill_step_fn: the last position's bf16 logits of the
    reference's step (which computes in bf16) against the port's
    (BF16_REL_L2, BF16_MAX_ABS); and the port's float32 prefill against
    the reference's float32 forward, both rounded to bf16 at the end, to
    one bf16 rounding."""
    arch, japi, jparams, api, tparams = model
    jshape, shape = jax_smoke_shape("prefill"), smoke_shape("prefill")
    assert (jshape.seq_len, jshape.global_batch) == (shape.seq_len,
                                                     shape.global_batch)
    toks = _tokens(api.cfg.vocab_size, shape.global_batch, shape.seq_len,
                   seed=4)
    want = jax_specs.make_prefill_step_fn(japi, jshape)(
        jparams, {"tokens": jnp.asarray(toks)})
    got = specs.make_prefill_step_fn(api, shape)(
        tparams, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.bfloat16 and got.shape == tuple(want.shape)
    diff = got.float().numpy() - np.asarray(want, np.float32)
    assert np.abs(diff).max() <= BF16_MAX_ABS
    assert np.linalg.norm(diff) <= BF16_REL_L2 * np.linalg.norm(
        np.asarray(want, np.float32))
    want32, _ = japi.forward(jparams, jnp.asarray(toks),
                             compute_dtype=jnp.float32, remat=False)
    got32 = specs.make_prefill_step_fn(
        api, shape, compute_dtype=torch.float32)(
            tparams, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(
        got32.float().numpy(),
        np.asarray(want32[:, -1].astype(jnp.bfloat16), np.float32),
        atol=1e-2, rtol=1e-2)


def test_slot_engine_matches_reference_engine(model):
    """Greedy tokens of the slot engine equal the reference engine's in
    float32, with 5 requests on 2 slots: three requests land on a slot
    a finished one left, and keep its state and position, as in the
    reference (the port used to reset the position and slot table on
    admission, which raised KeyError on xLSTM's cache and changed
    zamba2's tokens on a reused slot)."""
    arch, japi, jparams, api, tparams = model
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, api.cfg.vocab_size,
                            int(rng.integers(3, 9))).astype(np.int32)
               for _ in range(5)]
    max_new = [6, 3, 5, 4, 6]
    kw = dict(n_slots=2, cache_len=64)

    def drain(eng):
        for p, n in zip(prompts, max_new):
            eng.submit(p, n)
        return {r.request_id: list(r.generated)
                for r in eng.run_until_drained()}

    jeng = JaxSlotEngine(japi, jparams, cache_dtype=jnp.float32,
                         compute_dtype=jnp.float32, **kw)
    ref = drain(jeng)
    eng = DecodeEngine(api, tparams, cache_dtype=torch.float32,
                       compute_dtype=torch.float32, device="cpu", **kw)
    assert isinstance(eng, SlotDecodeEngine)
    got = drain(eng)
    assert got == ref and len(got) == len(prompts)
    # no lane was reset: every position counts all the engine's steps
    assert eng.cache["pos"].tolist() == np.asarray(
        jeng.cache["pos"]).tolist() == [eng.steps] * 2


def _train_batch(vocab, seed):
    toks = _tokens(vocab, 2, 64, seed)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    labels[0, 5] = -1
    return toks, labels


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _port_grads(api, tparams, batch):
    """(loss, {path: gradient}) of the port's float32 ``loss``."""
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in _flat(tparams).items()}

    def unflat(tree, prefix=""):
        return {k: unflat(v, f"{prefix}{k}/") if isinstance(v, dict)
                else leaves[f"{prefix}{k}"] for k, v in tree.items()}

    loss, _ = api.loss(unflat(tparams), batch, compute_dtype=torch.float32)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def _tb(toks, labels):
    return {"tokens": torch.from_numpy(toks).long(),
            "labels": torch.from_numpy(labels).long()}


def test_loss_and_grads_match_reference(model):
    """The float32 loss and the gradient of every leaf against
    ``jax.value_and_grad`` of the reference's
    ``forward(compute_dtype=float32)`` + ``lm_loss`` (its ``loss`` always
    computes in bf16), over two SSD chunks: loss to 1e-5, gradients to
    ``rtol = 1e-3, atol = 1e-6``, as ``test_torch_lm_train.py`` holds the
    dense family's."""
    from repro.models import transformer as jtf
    arch, japi, jparams, api, tparams = model
    toks, labels = _train_batch(api.cfg.vocab_size, seed=7)

    def jloss(p):
        logits, aux = japi.forward(p, jnp.asarray(toks),
                                   compute_dtype=jnp.float32)
        return jtf.lm_loss(logits, jnp.asarray(labels), aux, 0.0)[0]

    want_l, want_g = jax.jit(jax.value_and_grad(jloss))(jparams)
    loss, grads = _port_grads(api, tparams, _tb(toks, labels))
    np.testing.assert_allclose(float(loss), float(want_l), rtol=1e-5)
    want = {k: np.asarray(v) for k, v in _flat(want_g).items()}
    assert set(want) == set(grads)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k], rtol=1e-3, atol=1e-6,
                                   err_msg=k)


def test_train_step_update_matches_reference_adamw(model):
    """One float32 ``make_train_step_fn`` step: its loss and gradient norm
    are the port's loss and gradients', and its new parameters and AdamW
    moments equal the reference's ``adamw(lr, grad_clip_norm=1.0)``
    applied to the same gradients from the same state (the float32 keys
    included)."""
    from repro.optim import adamw as jadamw
    arch, japi, jparams, api, tparams = model
    toks, labels = _train_batch(api.cfg.vocab_size, seed=8)
    lr = 1e-3
    step, opt = specs.make_train_step_fn(
        api, smoke_shape("train"), lr=lr, compute_dtype=torch.float32)
    new_p, new_s, met = step(tparams, opt.init(tparams), _tb(toks, labels))
    loss, grads = _port_grads(api, tparams, _tb(toks, labels))
    assert float(met["loss"]) == float(loss)
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
    np.testing.assert_allclose(float(met["grad_norm"]), float(norm),
                               rtol=1e-6)

    def nest(flat, tree, prefix=""):
        return {k: nest(flat, v, f"{prefix}{k}/") if isinstance(v, dict)
                else jnp.asarray(flat[f"{prefix}{k}"].numpy())
                for k, v in tree.items()}

    jp = nest(_flat(tparams), tparams)
    jopt = jadamw(lr, grad_clip_norm=1.0)
    want_p, want_s = jax.jit(jopt.update)(nest(grads, tparams),
                                          jopt.init(jp), jp)
    for got, want in ((new_p, want_p), (new_s["m"], want_s["m"]),
                      (new_s["v"], want_s["v"])):
        want = _flat(want)
        for k, v in _flat(got).items():
            np.testing.assert_allclose(v.numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-9, err_msg=k)


def test_training_route_runs_no_scan_kernel(model, monkeypatch):
    """The prefill forward leaves the scans to the default rule (None: the
    kernel on CUDA tensors), while the loss asks for their plain
    chunkwise forms by an explicit ``use_kernel=False`` (a spy on
    ``ops.ssd_scan_heads`` / ``ops.mlstm_scan_heads``), in the forward
    and in the recompute of every checkpointed segment; a direct scan
    kernel call under grad mode still raises."""
    from repro_torch.kernels import ops
    arch, _, _, api, tparams = model
    name = "ssd_scan_heads" if arch == "zamba2-2.7b" else "mlstm_scan_heads"
    seen = []
    real = getattr(ops, name)

    def spy(*a, use_kernel=None, **kw):
        seen.append(use_kernel)
        return real(*a, use_kernel=use_kernel, **kw)

    monkeypatch.setattr(ops, name, spy)
    toks, labels = _train_batch(api.cfg.vocab_size, seed=9)
    with torch.no_grad():
        api.forward(tparams, torch.from_numpy(toks))
    n = len(seen)                         # one scan a layer
    assert n and seen == [None] * n
    _port_grads(api, tparams, _tb(toks, labels))
    # the forward, then the checkpointed segments' recompute in backward
    assert seen[n:] == [False] * (2 * n)
    x = torch.zeros(1, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops._refuse_grad(name, x)
