"""The port's VLM (llava-next-mistral-7b: the projector and the Mistral
text backbone with its sliding window) against the reference, on the CPU:
parameters converted from the reference's ``init``, patch embeddings and
tokens made with numpy from a seed."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.shapes import InputShape as JaxInputShape
from repro.launch.specs import make_prefill_step_fn as jax_prefill_fn
from repro.models import build_model as jax_build_model
from repro.models import transformer as jax_tf
from repro.models import vlm as jax_vlm
from repro.serving import PagedDecodeEngine as JaxPagedEngine
from repro_torch.configs import get_config
from repro_torch.configs.shapes import InputShape
from repro_torch.launch.specs import make_prefill_step_fn
from repro_torch.models import vlm
from repro_torch.models.api import build_model
from repro_torch.models.convert import from_reference_params
from repro_torch.serving.engine import PagedDecodeEngine

ARCH = "llava-next-mistral-7b"
# float32 on both sides, contracting in different orders (the smoke
# stack's logits read ~3e-6 max abs apart)
ATOL = RTOL = 1e-4


@pytest.fixture(scope="module")
def model():
    jcfg = jax_get_config(ARCH).smoke_variant()
    cfg = get_config(ARCH).smoke_variant()
    japi = jax_build_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    tparams = from_reference_params(jax.tree.map(np.asarray, jparams),
                                    device="cpu", dtype=torch.float32)
    return jcfg, japi, jparams, cfg, build_model(cfg), tparams


def _inputs(cfg, B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    patches = rng.standard_normal((B, cfg.frontend.n_tokens,
                                   cfg.frontend.d_embed)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return patches, tokens


def test_config_and_init_tree_match_reference():
    """The config copy equals the reference's, full and smoke, and the
    port's own init makes the reference's tree (projector and ``lm``)."""
    for smoke in (False, True):
        j, t = jax_get_config(ARCH), get_config(ARCH)
        if smoke:
            j, t = j.smoke_variant(), t.smoke_variant()
        assert dataclasses.asdict(t) == dataclasses.asdict(j), smoke
    jcfg = jax_get_config(ARCH).smoke_variant()
    jtree = jax.eval_shape(lambda: jax_vlm.init_params(
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_project_patches_matches_reference(model, dtype):
    """The projector (w1, tanh-approximate GELU, w2): float32 within
    1e-5; bfloat16 within a few bf16 ulps of the output's scale."""
    jcfg, japi, jparams, cfg, api, tparams = model
    patches, _ = _inputs(cfg)
    want = np.asarray(jax_vlm.project_patches(
        jparams, jnp.asarray(patches), getattr(jnp, dtype)),
        np.float32)
    got = vlm.project_patches(tparams, torch.from_numpy(patches),
                              getattr(torch, dtype)).float().numpy()
    assert got.shape == (2, cfg.frontend.n_tokens, cfg.d_model)
    tol = 1e-5 if dtype == "float32" else 2e-2 * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def test_forward_with_patches_and_loss_match_reference(model):
    """Logits over patches + tokens against the reference's float32
    forward; the loss with the patch positions labelled -1 against the
    reference's ``lm_loss`` on the same padded labels (its ``loss_fn``
    always computes in bf16)."""
    jcfg, japi, jparams, cfg, api, tparams = model
    patches, tokens = _inputs(cfg, seed=1)
    labels = np.random.default_rng(2).integers(
        0, cfg.vocab_size, tokens.shape).astype(np.int32)
    jl, jaux = japi.forward(jparams, jnp.asarray(tokens),
                            patches=jnp.asarray(patches),
                            compute_dtype=jnp.float32, remat=False)
    tl, _ = api.forward(tparams, torch.from_numpy(tokens),
                        patches=torch.from_numpy(patches),
                        compute_dtype=torch.float32, remat=False)
    assert tl.shape == (2, cfg.frontend.n_tokens + 16, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=RTOL)
    pad = -np.ones(patches.shape[:2], np.int32)
    jloss, _ = jax_tf.lm_loss(jl, jnp.asarray(np.concatenate(
        [pad, labels], 1)), jaux, 0.0)
    tloss, tm = api.loss(tparams, {"tokens": torch.from_numpy(tokens),
                                   "labels": torch.from_numpy(labels),
                                   "patches": torch.from_numpy(patches)},
                         compute_dtype=torch.float32, remat=False)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    assert float(tm["tokens"]) == labels.size


def test_prefill_step_matches_reference(model):
    """``make_prefill_step_fn`` with patches: the last position's logits
    in bf16.  The port's step in float32 against the reference's float32
    forward (both rounded to bf16 at the end: one bf16 ulp), and the two
    bf16 steps against each other (bf16 roundings in different orders,
    relative 2-norm)."""
    jcfg, japi, jparams, cfg, api, tparams = model
    patches, tokens = _inputs(cfg, B=1, S=24, seed=3)
    n = cfg.frontend.n_tokens + 24
    batch = {"tokens": torch.from_numpy(tokens),
             "patches": torch.from_numpy(patches)}
    got32 = make_prefill_step_fn(api, InputShape("p", n, 1, "prefill"),
                                 compute_dtype=torch.float32)(tparams, batch)
    jl, _ = japi.forward(jparams, jnp.asarray(tokens),
                         patches=jnp.asarray(patches),
                         compute_dtype=jnp.float32, remat=False)
    want32 = np.asarray(jl)[:, -1]
    assert got32.dtype == torch.bfloat16 and got32.shape == (1, cfg.vocab_size)
    np.testing.assert_allclose(got32.float().numpy(), want32,
                               rtol=2 ** -7, atol=1e-3)
    got16 = make_prefill_step_fn(api, InputShape("p", n, 1, "prefill"))(
        tparams, batch).float().numpy()
    want16 = np.asarray(jax_prefill_fn(
        japi, JaxInputShape("p", n, 1, "prefill"))(
        jparams, {"tokens": jnp.asarray(tokens),
                  "patches": jnp.asarray(patches)}), np.float32)
    rel = np.linalg.norm(got16 - want16) / np.linalg.norm(want16)
    assert rel < 2e-2, rel


def test_paged_engine_matches_reference_engine(model):
    """The text backbone served through the paged engine with its
    defaults: the reference engine's greedy tokens, with requests running
    past the smoke config's 64-token sliding window."""
    jcfg, japi, jparams, cfg, api, tparams = model
    window = api.effective_window(128)
    assert window == 64
    rng = np.random.default_rng(7)
    pre = rng.integers(0, cfg.vocab_size, 8).astype(np.int32)
    prompts = [np.concatenate([pre, rng.integers(
        0, cfg.vocab_size, int(rng.integers(30, 40))).astype(np.int32)])
        for _ in range(3)]
    kw = dict(n_slots=3, cache_len=128, window=window)

    def drain(eng):
        for p in prompts:
            eng.submit(p, 40)
        return {r.request_id: list(r.generated)
                for r in eng.run_until_drained()}

    ref = drain(JaxPagedEngine(japi, jparams, cache_dtype=jnp.float32,
                               compute_dtype=jnp.float32, **kw))
    eng = PagedDecodeEngine(api, tparams, cache_dtype=torch.float32,
                            device="cpu", **kw)
    assert drain(eng) == ref
    assert max(len(p) for p in prompts) + 40 > window
    s = eng.stats()
    assert (s["ragged"], s["tiled"]) == (1, 1) and s["spec_verifications"] > 0
