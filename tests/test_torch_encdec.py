"""The port's audio family (whisper-base: the encoder-decoder backbone of
``models/encdec.py``) against the reference's, on the smoke config on the
CPU: parameters converted from the reference's ``init``, frame
embeddings and tokens made with numpy from a seed.

The reference's ``forward`` and ``loss_fn`` for this family compute in
bfloat16 whatever ``compute_dtype`` they are given (``_encdec_forward``
swallows it), so the float32 comparisons compose the reference's
``encode(compute_dtype=float32)``, ``decode_train`` and ``lm_loss``, and
the port runs ``compute_dtype=torch.float32``.  Tolerances (float32 on
both sides, contracting in other orders over 2 + 2 layers and a 512-way
softmax): activations, logits and the loss ``ATOL = RTOL = 1e-4`` (the
readings are a few 1e-6), gradients ``rtol = 1e-3, atol = 1e-6``, as
``test_torch_lm_train.py`` holds the dense family's.  bfloat16 results
round at other places in the two frameworks and are held as
``test_torch_recurrent.py`` holds its bf16 prefill.
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
from repro.models import encdec as jencdec
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro.optim import global_norm as jglobal_norm
from repro.serving.engine import SlotDecodeEngine as JaxSlotEngine
from repro_torch.configs import get_config
from repro_torch.configs.shapes import InputShape, smoke_shape
from repro_torch.launch import specs
from repro_torch.launch import train as train_launcher
from repro_torch.models import encdec
from repro_torch.models.api import build_model
from repro_torch.models.common import keeps_float32
from repro_torch.models.convert import from_reference_params
from repro_torch.serving.engine import DecodeEngine, SlotDecodeEngine

ARCH = "whisper-base"
ATOL = RTOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-6
# the bf16 steps of the two packages (as test_torch_recurrent.py's)
BF16_REL_L2 = 3e-2
BF16_MAX_ABS = 0.1
B, S = 2, 16


@pytest.fixture(scope="module")
def model():
    jcfg = jax_get_config(ARCH).smoke_variant()
    japi = jax_build_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    tparams = from_reference_params(jax.tree.map(np.asarray, jparams),
                                    device="cpu", dtype=torch.float32)
    api = build_model(get_config(ARCH).smoke_variant())
    return jcfg, japi, jparams, api, tparams


def _inputs(cfg, seed, b=B, s=S):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal(
        (b, cfg.encoder_positions, cfg.frontend.d_embed)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    return frames, tokens, labels


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _close(got, want, atol=ATOL, rtol=RTOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol, err_msg=msg)


def test_config_and_init_tree_match_reference():
    """The config copy equals the reference's, full and smoke, and the
    port's own init makes the reference's tree: the same names and shapes,
    weights in the compute dtype and the norms in float32."""
    for smoke in (False, True):
        j, t = jax_get_config(ARCH), get_config(ARCH)
        if smoke:
            j, t = j.smoke_variant(), t.smoke_variant()
        assert dataclasses.asdict(t) == dataclasses.asdict(j), smoke
    jcfg = jax_get_config(ARCH).smoke_variant()
    jtree = jax.eval_shape(lambda: jencdec.init_params(
        jax.random.PRNGKey(0), jcfg))
    tparams = build_model(get_config(ARCH).smoke_variant()).init(
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


def test_encode_and_encoder_kv_match_reference(model):
    """``encode`` in float32 (frame projection, sinusoids, bidirectional
    blocks, final norm) and the cross K/V it gives every decoder layer."""
    jcfg, japi, jparams, api, tparams = model
    frames, _, _ = _inputs(api.cfg, seed=0)
    want = jencdec.encode(jparams, jnp.asarray(frames), jcfg,
                          compute_dtype=jnp.float32, remat=False)
    got = encdec.encode(tparams, torch.from_numpy(frames), api.cfg,
                        compute_dtype=torch.float32, remat=False)
    assert got.dtype == torch.float32 and got.shape == tuple(want.shape)
    _close(got, want)
    # the two frameworks' float32 exp and sin round differently: the
    # tables read one ulp of the largest angle apart (63 rad: 3.8e-6)
    np.testing.assert_allclose(
        encdec.sinusoids(64, 256).numpy(),
        np.asarray(jencdec.sinusoids(64, 256)), atol=1e-5)
    jkv = jencdec.encoder_kv(jparams, want, jcfg)
    tkv = encdec.encoder_kv(tparams, torch.from_numpy(np.array(want)),
                            api.cfg)
    for name in ("k", "v"):
        assert tkv[name].shape == tuple(jkv[name].shape)
        _close(tkv[name], jkv[name], msg=name)


def test_decode_train_matches_reference(model):
    """Teacher-forced decoder logits in float32 from the same encoder
    output, and the api's forward (the port honours ``compute_dtype``)
    against the reference's float32 composition."""
    jcfg, japi, jparams, api, tparams = model
    frames, tokens, _ = _inputs(api.cfg, seed=1)
    enc = jencdec.encode(jparams, jnp.asarray(frames), jcfg,
                         compute_dtype=jnp.float32)
    want = jencdec.decode_train(jparams, jnp.asarray(tokens), enc, jcfg,
                                remat=False)
    got = encdec.decode_train(tparams, torch.from_numpy(tokens),
                              torch.from_numpy(np.asarray(enc)), api.cfg,
                              remat=False)
    assert got.dtype == torch.float32
    _close(got, want)
    fwd, aux = api.forward(tparams, torch.from_numpy(tokens),
                           frames=torch.from_numpy(frames),
                           compute_dtype=torch.float32, remat=False)
    assert float(aux) == 0.0
    _close(fwd, want)


def test_loss_and_grads_match_reference(model):
    """The float32 loss (labels -1 ignored, z-loss) and the gradient of
    every parameter, against ``jax.value_and_grad`` of the reference's
    float32 composition."""
    jcfg, japi, jparams, api, tparams = model
    frames, tokens, labels = _inputs(api.cfg, seed=2)

    def jloss(p):
        enc = jencdec.encode(p, jnp.asarray(frames), jcfg,
                             compute_dtype=jnp.float32)
        logits = jencdec.decode_train(p, jnp.asarray(tokens), enc, jcfg)
        return jtf.lm_loss(logits, jnp.asarray(labels))[0]

    want_l, want_g = jax.jit(jax.value_and_grad(jloss))(jparams)
    flat = _flat(tparams)
    leaves = {k: v.clone().requires_grad_(True) for k, v in flat.items()}

    def unflat(tree, prefix=""):
        return {k: unflat(v, f"{prefix}{k}/") if isinstance(v, dict)
                else leaves[f"{prefix}{k}"] for k, v in tree.items()}

    batch = {"frames": torch.from_numpy(frames),
             "tokens": torch.from_numpy(tokens).long(),
             "labels": torch.from_numpy(labels).long()}
    loss, met = api.loss(unflat(tparams), batch, compute_dtype=torch.float32)
    assert float(met["tokens"]) == B * (S - 1)
    np.testing.assert_allclose(float(loss.detach()), float(want_l),
                               rtol=1e-5)
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    want = {k: np.asarray(v) for k, v in _flat(want_g).items()}
    assert set(want) == set(grads)
    for k, g in grads.items():
        _close(g, want[k], atol=GRAD_ATOL, rtol=GRAD_RTOL, msg=k)


def test_bf16_loss_and_train_step_match_reference(model):
    """The reference's bfloat16 loss and gradient norm (its
    ``make_train_step_fn`` reports them from ``make_loss_for_shape``)
    against one step of the port's ``make_train_step_fn`` from the same
    float32 masters (losses to 1e-2, gradient norms to 5e-2, as the dense
    family's); and that step's update equals the reference's ``adamw``
    applied to the port's own gradients and the same state."""
    from repro.configs.shapes import InputShape as JShape
    jcfg, japi, jparams, api, tparams = model
    frames, tokens, labels = _inputs(api.cfg, seed=3)
    jb = {"frames": jnp.asarray(frames, jnp.bfloat16),
          "tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    tb = {"frames": torch.from_numpy(frames).to(torch.bfloat16),
          "tokens": torch.from_numpy(tokens).long(),
          "labels": torch.from_numpy(labels).long()}
    jloss = jax_specs.make_loss_for_shape(japi, JShape("t", S, B, "train"))
    (jl, _), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jparams, jb)
    jmet = {"loss": jl, "grad_norm": jglobal_norm(jgrads)}
    tstep, topt = specs.make_train_step_fn(
        api, InputShape("t", S, B, "train"), lr=1e-3)
    state = topt.init(tparams)
    new_p, new_s, tmet = tstep(tparams, state, tb)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=1e-2)
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=5e-2)
    # the reference's adamw on the port's gradients of the same step
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in _flat(tparams).items()}

    def unflat(tree, prefix=""):
        return {k: unflat(v, f"{prefix}{k}/") if isinstance(v, dict)
                else leaves[f"{prefix}{k}"] for k, v in tree.items()}

    loss, _ = specs.make_loss_for_shape(
        api, InputShape("t", S, B, "train"))(unflat(tparams), tb)
    g = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))

    def nest(flat_np, tree, prefix=""):
        return {k: nest(flat_np, v, f"{prefix}{k}/") if isinstance(v, dict)
                else jnp.asarray(flat_np[f"{prefix}{k}"])
                for k, v in tree.items()}

    jg = nest({k: v.numpy() for k, v in g.items()}, tparams)
    jp = nest({k: v.numpy() for k, v in _flat(tparams).items()}, tparams)
    jopt = jadamw(1e-3, grad_clip_norm=1.0)
    want_p, _ = jax.jit(jopt.update)(jg, jopt.init(jp), jp)
    want = {k: np.asarray(v) for k, v in _flat(want_p).items()}
    for k, v in _flat(new_p).items():
        _close(v, want[k], atol=1e-7, rtol=1e-6, msg=k)


def test_decode_steps_match_reference_and_forward(model):
    """A run of ``decode_step`` logits in float32 with the cross K/V
    filled from ``encode`` -> ``encoder_kv`` on both sides, against the
    reference's steps, and against the port's own forward
    (``tests/test_decode_consistency.py``'s property, here at ATOL)."""
    jcfg, japi, jparams, api, tparams = model
    frames, tokens, _ = _inputs(api.cfg, seed=4)
    jenc = jencdec.encode(jparams, jnp.asarray(frames), jcfg,
                          compute_dtype=jnp.float32)
    jcache = japi.init_cache(B, S, dtype=jnp.float32)
    jcache["cross"] = jencdec.encoder_kv(jparams, jenc, jcfg)
    tf_frames = torch.from_numpy(frames)
    tenc = encdec.encode(tparams, tf_frames, api.cfg,
                         compute_dtype=torch.float32)
    cache = api.init_cache(B, S, dtype=torch.float32, device="cpu")
    cache["cross"] = encdec.encoder_kv(tparams, tenc, api.cfg)
    jstep = jax.jit(lambda p, c, t: japi.decode_step(
        p, c, t, compute_dtype=jnp.float32))
    outs = []
    for t in range(S):
        jl, jcache = jstep(jparams, jcache, jnp.asarray(tokens[:, t:t + 1]))
        tl, cache = api.decode_step(tparams, cache,
                                    torch.from_numpy(tokens[:, t:t + 1]),
                                    compute_dtype=torch.float32)
        _close(tl, jl, msg=f"step {t}")
        outs.append(tl[:, 0])
    assert cache["pos"].tolist() == [S] * B
    fwd, _ = api.forward(tparams, torch.from_numpy(tokens), frames=tf_frames,
                         compute_dtype=torch.float32, remat=False)
    _close(torch.stack(outs, 1), fwd)


def test_prefill_step_matches_reference(model):
    """make_prefill_step_fn with frames: the reference's bf16 step (its
    forward computes in bf16) against the port's (BF16_REL_L2,
    BF16_MAX_ABS); the port's float32 step against the reference's
    float32 composition, both rounded to bf16, to one bf16 rounding."""
    jcfg, japi, jparams, api, tparams = model
    jshape, shape = jax_smoke_shape("prefill"), smoke_shape("prefill")
    frames, tokens, _ = _inputs(api.cfg, seed=5, b=shape.global_batch,
                                s=shape.seq_len)
    want = jax_specs.make_prefill_step_fn(japi, jshape)(
        jparams, {"tokens": jnp.asarray(tokens),
                  "frames": jnp.asarray(frames)})
    tb = {"tokens": torch.from_numpy(tokens),
          "frames": torch.from_numpy(frames)}
    got = specs.make_prefill_step_fn(api, shape)(tparams, tb)
    assert got.dtype == torch.bfloat16 and got.shape == tuple(want.shape)
    diff = got.float().numpy() - np.asarray(want, np.float32)
    assert np.abs(diff).max() <= BF16_MAX_ABS
    assert np.linalg.norm(diff) <= BF16_REL_L2 * np.linalg.norm(
        np.asarray(want, np.float32))
    enc = jencdec.encode(jparams, jnp.asarray(frames), jcfg,
                         compute_dtype=jnp.float32)
    want32 = jencdec.decode_train(jparams, jnp.asarray(tokens), enc, jcfg)
    got32 = specs.make_prefill_step_fn(
        api, shape, compute_dtype=torch.float32)(tparams, tb)
    _close(got32.float(),
           np.asarray(want32[:, -1].astype(jnp.bfloat16), np.float32),
           atol=1e-2, rtol=1e-2)


def test_slot_engine_matches_reference_engine(model):
    """Greedy tokens of the slot engine equal the reference engine's in
    float32, with 5 requests on 2 slots, so three requests take a lane a
    finished one left: as in the reference, an encoder-decoder cache has
    no ``scan`` key, so a reused lane keeps its position and KV, and its
    cross K/V stay zero (the reference's engine never fills them)."""
    jcfg, japi, jparams, api, tparams = model
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, api.cfg.vocab_size,
                            int(rng.integers(3, 9))).astype(np.int32)
               for _ in range(5)]
    max_new = [6, 3, 5, 4, 6]
    kw = dict(n_slots=2, cache_len=48)

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
    assert eng.cache["pos"].tolist() == np.asarray(
        jeng.cache["pos"]).tolist() == [eng.steps] * 2
    assert not eng.cache["cross"]["k"].any()


@pytest.mark.parametrize("arch,name", [("whisper-base", "frames"),
                                       ("llava-next-mistral-7b", "patches")])
def test_train_launcher_feeds_the_frontend(arch, name, monkeypatch, capsys):
    """One step of ``launch/train.py`` on the smoke config gives the loss
    the frontend embeddings the reference's launcher builds (bf16, drawn
    from the step's generator): ``frames`` (B, encoder_positions, d_embed)
    for audio, ``patches`` (B, n_tokens, d_embed) for the VLM."""
    seen = []
    real = specs.make_train_step_fn

    def spy(*a, **kw):
        step, opt = real(*a, **kw)

        def wrapped(params, state, batch):
            seen.append({k: (tuple(v.shape), v.dtype)
                         for k, v in batch.items()})
            return step(params, state, batch)

        return wrapped, opt

    monkeypatch.setattr(train_launcher.specs_lib, "make_train_step_fn", spy)
    train_launcher.main(["--arch", arch, "--device", "cpu", "--steps", "1",
                         "--batch", "2", "--seq", "16"])
    assert capsys.readouterr().out.strip().endswith("done")
    cfg = get_config(arch).smoke_variant()
    n = cfg.encoder_positions if name == "frames" else cfg.frontend.n_tokens
    assert seen[0][name] == ((2, n, cfg.frontend.d_embed), torch.bfloat16)
    assert seen[0]["tokens"][0] == (2, 16)
