"""The port's flash attention (B6 forward, B6f forward with logsumexp, B6b
backward) and the model's causal attention against the reference's.

Inputs are made with numpy from a seed and fed to both packages.  The
port's plain versions (``repro_torch.kernels.ref``) are held to the
reference's jnp oracle and to its Pallas kernels in interpret mode
(``_flash_fwd_lse``, and ``jax.grad`` of ``flash_attention_trainable``)
on the sweeps of ``tests/test_kernels_attention.py`` and
``tests/test_kernels_attention_bwd.py``, at their tolerances: outputs and
logsumexp at ``atol = rtol = 2e-5``, gradients at ``atol = 2e-5, rtol =
2e-4`` (float32 summed in other orders).  ``layers.causal_attention`` is
held to the reference's on both sides of ``chunk_threshold`` at the same
tolerances.  The CUDA kernels themselves are held to the plain versions
on the card; those cases are marked ``cuda`` and skip where there is no
card.  The bfloat16 kernels' backward arithmetic (p and ds split into
bfloat16 terms for the tensor cores) is emulated here in plain PyTorch
and held to ``jax.grad`` of the reference's oracle.  The JAX side is imported by the tests that use it, so that the
CUDA cases also run on a machine that has no JAX:

    python -m pytest -q --noconftest -m cuda tests/test_torch_flash_attention.py
"""
import ctypes
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models import layers

ATOL = RTOL = 2e-5
GRAD_ATOL, GRAD_RTOL = 2e-5, 2e-4

# tests/test_kernels_attention.py:20-28 and test_kernels_attention_bwd.py:
# 10-16 -- B, H, Hkv, S, D, window, block_q, block_kv
FWD_SWEEP = [
    (1, 1, 1, 128, 32, 0, 64, 64),
    (2, 4, 2, 256, 64, 0, 64, 64),
    (2, 4, 1, 256, 64, 0, 128, 64),
    (1, 8, 8, 256, 16, 0, 64, 128),
    (2, 4, 2, 256, 64, 96, 64, 64),
    (1, 2, 2, 512, 64, 128, 128, 128),
    (1, 2, 1, 384, 48, 100, 64, 64),
]
BWD_SWEEP = [
    (1, 2, 1, 128, 32, 0, 64, 64),
    (2, 4, 2, 256, 32, 0, 64, 64),
    (2, 4, 2, 256, 32, 96, 64, 64),
    (1, 4, 4, 128, 64, 0, 64, 32),
    (1, 8, 2, 128, 16, 40, 32, 32),
]


@pytest.fixture
def jax_side():
    """The reference package's attention oracle, Pallas kernels (run in
    interpret mode), ops wrapper and model layers."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.kernels import flash_attention as jfa
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.models import layers as jlayers
    return dict(jax=jax, jnp=jnp, fa=jfa, ops=jops, ref=jref,
                layers=jlayers)


def _qkv(seed, B, H, Hkv, S, D, layout="bhsd"):
    """q, k, v (and a cotangent like q) as numpy float32, standard
    normal, in (B, H, S, D) or the model's (B, S, H, D) layout."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    if layout == "bhsd":
        return f(B, H, S, D), f(B, Hkv, S, D), f(B, Hkv, S, D), f(B, H, S, D)
    return f(B, S, H, D), f(B, S, Hkv, D), f(B, S, Hkv, D), f(B, S, H, D)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("B,H,Hkv,S,D,window,bq,bkv", FWD_SWEEP)
def test_plain_forward_matches_reference_and_kernel(jax_side, B, H, Hkv, S,
                                                     D, window, bq, bkv):
    """attention_reference and attention_lse_reference (the plain
    versions of B6 and B6f) against the jnp oracle and the interpret-mode
    ``_flash_fwd_lse``; the CPU wrappers run them."""
    jnp = jax_side["jnp"]
    q, k, v, _ = _qkv(0, B, H, Hkv, S, D)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = np.asarray(jax_side["ref"].attention_reference(
        jq, jk, jv, causal=True, window=window))
    jo, jlse = jax_side["fa"]._flash_fwd_lse(
        jq, jk, jv, causal=True, window=window, block_q=bq, block_kv=bkv,
        interpret=True)
    tq, tk, tv = _t(q, k, v)
    o = tref.attention_reference(tq, tk, tv, window=window)
    o2, lse = tref.attention_lse_reference(tq, tk, tv, window=window)
    for got in (o, o2, tfa.flash_attention(tq, tk, tv, window=window),
                tfa.flash_attention_lse(tq, tk, tv, window=window)[0]):
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(jo), atol=ATOL,
                                   rtol=RTOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("window", [0, 96])
def test_plain_forward_bf16_matches_reference(jax_side, window):
    """bfloat16 inputs: both packages compute in float32 and round the
    output once, so they agree to one bfloat16 rounding (2^-8 relative)."""
    jnp = jax_side["jnp"]
    q, k, v, _ = _qkv(1, 2, 4, 2, 256, 64)
    want = np.asarray(jax_side["ref"].attention_reference(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal=True,
        window=window).astype(jnp.float32))
    got = tref.attention_reference(
        *(t.to(torch.bfloat16) for t in _t(q, k, v)), window=window)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2,
                               rtol=1e-2)


@pytest.mark.parametrize("B,H,Hkv,S,D,window,bq,bkv", BWD_SWEEP)
def test_plain_backward_matches_reference_grads(jax_side, B, H, Hkv, S, D,
                                                window, bq, bkv):
    """attention_bwd_reference (the plain version of B6b) from the plain
    forward's o and lse, and flash_attention_trainable's autograd on CPU
    tensors, against ``jax.grad`` of the interpret-mode
    ``flash_attention_trainable`` and of the jnp oracle."""
    jax, jnp = jax_side["jax"], jax_side["jnp"]
    q, k, v, ct = _qkv(2, B, H, Hkv, S, D)
    jq, jk, jv, jct = map(jnp.asarray, (q, k, v, ct))
    jfa = jax_side["fa"]

    def f(q_, k_, v_):
        o = jfa.flash_attention_trainable(q_, k_, v_, True, window, bq, bkv,
                                          True)
        return (o * jct).sum()

    def r(q_, k_, v_):
        o = jax_side["ref"].attention_reference(q_, k_, v_, causal=True,
                                                window=window)
        return (o * jct).sum()

    gk = jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)
    gr = jax.grad(r, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv, tct = _t(q, k, v, ct)
    o, lse = tref.attention_lse_reference(tq, tk, tv, window=window)
    plain = tref.attention_bwd_reference(tq, tk, tv, o, lse, tct,
                                         window=window)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    (tfa.flash_attention_trainable(*leaves, True, window) * tct).sum(
        ).backward()
    for got in (plain, [t.grad for t in leaves]):
        for a, b, c in zip(got, gk, gr):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       atol=GRAD_ATOL, rtol=GRAD_RTOL)
            np.testing.assert_allclose(a.numpy(), np.asarray(c),
                                       atol=GRAD_ATOL, rtol=GRAD_RTOL)


@pytest.mark.parametrize("window", [0, 40])
def test_plain_versions_without_causal_mask(jax_side, window):
    """causal=False (the reference kernels' other mode): the plain
    forward, logsumexp and backward against the jnp oracle's value and
    ``jax.grad``; the logsumexp against the interpret-mode kernel."""
    jax, jnp = jax_side["jax"], jax_side["jnp"]
    q, k, v, ct = _qkv(6, 1, 4, 2, 128, 32)
    jq, jk, jv, jct = map(jnp.asarray, (q, k, v, ct))

    def r(q_, k_, v_):
        o = jax_side["ref"].attention_reference(q_, k_, v_, causal=False,
                                                window=window)
        return (o * jct).sum(), o

    (_, want), jg = jax.value_and_grad(r, argnums=(0, 1, 2), has_aux=True)(
        jq, jk, jv)
    _, jlse = jax_side["fa"]._flash_fwd_lse(
        jq, jk, jv, causal=False, window=window, block_q=64, block_kv=64,
        interpret=True)
    tq, tk, tv, tct = _t(q, k, v, ct)
    o, lse = tref.attention_lse_reference(tq, tk, tv, causal=False,
                                          window=window)
    np.testing.assert_allclose(o.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=ATOL,
                               rtol=RTOL)
    for a, b in zip(tref.attention_bwd_reference(
            tq, tk, tv, o, lse, tct, causal=False, window=window), jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL)


def test_bshd_wrapper_pads_like_reference(jax_side):
    """ops.flash_attention_bshd on CPU tensors (the reference wrapper's
    padding of S = 200 to a block multiple, around the plain version)
    against the reference wrapper in interpret mode; differentiable."""
    jnp = jax_side["jnp"]
    q, k, v, ct = _qkv(3, 2, 4, 2, 200, 32, layout="bshd")
    want = np.asarray(jax_side["ops"].flash_attention_bshd(
        *map(jnp.asarray, (q, k, v)), block_q=64, block_kv=64,
        interpret=True))
    leaves = [t.clone().requires_grad_(True) for t in _t(q, k, v)]
    got = ops.flash_attention_bshd(*leaves, block_q=64, block_kv=64)
    assert got.shape == (2, 200, 4, 32)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL,
                               rtol=RTOL)
    pinned = ops.flash_attention_bshd(*_t(q, k, v), block_q=64, block_kv=64,
                                      use_kernel=False)
    assert torch.equal(pinned, got.detach())
    (got * torch.from_numpy(ct)).sum().backward()
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all())
               for t in leaves)
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention_bshd(*_t(q, k, v), use_kernel=True)


# (S, window, chunk_threshold, chunk): full attention below the threshold;
# above it the causal online-softmax schedule, the sliding-window band
# (window + chunk < S) and a window too wide for the band
CAUSAL_CASES = [(64, 0, 2048, 512), (64, 24, 2048, 512),
                (128, 0, 64, 32), (128, 40, 64, 32), (128, 100, 64, 32)]


@pytest.mark.parametrize("S,window,threshold,chunk", CAUSAL_CASES)
def test_causal_attention_matches_reference(jax_side, S, window, threshold,
                                            chunk):
    """layers.causal_attention on CPU tensors takes the reference's split
    (full / chunked) and agrees with the reference, value and
    gradients."""
    jax, jnp = jax_side["jax"], jax_side["jnp"]
    q, k, v, ct = _qkv(4, 2, 4, 2, S, 32, layout="bshd")
    jl = jax_side["layers"]
    jct = jnp.asarray(ct)

    def jf(q_, k_, v_):
        out = jl.causal_attention(q_, k_, v_, window=window,
                                  chunk_threshold=threshold, chunk=chunk)
        return (out * jct).sum(), out

    (_, want), jg = jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, (q, k, v)))
    leaves = [t.clone().requires_grad_(True) for t in _t(q, k, v)]
    got = layers.causal_attention(*leaves, window=window,
                                  chunk_threshold=threshold, chunk=chunk)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)
    (got * torch.from_numpy(ct)).sum().backward()
    for t, g in zip(leaves, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL)
    # the plain flash version computes the same function
    flash = ops.flash_attention_bshd(*_t(q, k, v), window=window)
    np.testing.assert_allclose(flash.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_chunked_schedules_match_full_attention():
    """Both chunked schedules equal full attention (the reference's own
    identity), in float32 and, to a bfloat16 rounding, in bfloat16."""
    q, k, v, _ = _qkv(5, 1, 4, 1, 96, 16, layout="bshd")
    for dt, tol in ((torch.float32, 2e-5), (torch.bfloat16, 3e-2)):
        tq, tk, tv = (t.to(dt) for t in _t(q, k, v))
        for window in (0, 20, 80):
            full = layers.full_attention(tq, tk, tv, window=window)
            chunked = layers.chunked_attention(tq, tk, tv, window=window,
                                               chunk=32)
            assert chunked.dtype == dt
            np.testing.assert_allclose(chunked.float().numpy(),
                                       full.float().numpy(), atol=tol,
                                       rtol=tol)


# ---------------------------------------------------------------------------
# The bfloat16 backward's arithmetic, emulated on the CPU
# ---------------------------------------------------------------------------
def _chip_smoke_limits():
    """chip_smoke.py's bfloat16 gradient limits (rtol, atol, rel_l2)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return (mod.FA_BF16_RTOL, mod.FA_BF16_GRAD_ATOL,
            mod.FA_BF16_REL_L2["grad"])


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _split(x, terms):
    """x as ``terms`` bfloat16 terms, each the rounding of what the ones
    before it leave (``hopper_common.cuh::split_bf16``)."""
    out = []
    for _ in range(terms):
        out.append(_bf16(x))
        x = x - out[-1]
    return out


def _bf16_backward_emulation(q, k, v, do, o, lse, window, terms):
    """(dq, dk, dv) as ``flash_attention_bwd_wgmma.cu`` computes them,
    float32 sums standing in for the tensor cores': s and dp from the
    bfloat16 inputs (products exact), the scale after the product, and p
    and ds split into ``terms`` bfloat16 terms in dv = p^T do, dq = ds k
    and dk = ds^T q; causal."""
    B, H, S, D = q.shape
    G = H // k.shape[1]
    kx, vx = (t.repeat_interleave(G, dim=1) for t in (k, v))
    s = (q @ kx.transpose(-1, -2)) * (1.0 / D ** 0.5)
    p = torch.where(tref._band_mask(S, True, window, q.device),
                    torch.exp(s - lse[..., None]), 0.0)
    ds = p * (do @ vx.transpose(-1, -2) - (do * o).sum(-1)[..., None]) \
        * (1.0 / D ** 0.5)
    per_kv = lambda t: t.reshape(B, -1, G, S, D).sum(2)
    dq = sum(t @ kx for t in _split(ds, terms))
    dk = per_kv(sum(t.transpose(-1, -2) @ q for t in _split(ds, terms)))
    dv = per_kv(sum(t.transpose(-1, -2) @ do for t in _split(p, terms)))
    return dq, dk, dv


# the card test's limits (below) for the kernels' three terms; two terms
# read up to 1.4e-6 here, within chip_smoke's 2e-5 but not the card
# test's 1e-6; one rounding (FlashAttention-2/3's) reads 1.7e-3-9.3e-3,
# about 100x chip_smoke's atol and 5x its rel_l2
@pytest.mark.parametrize("terms", [3, 2, 1])
@pytest.mark.parametrize("D,window", [(64, 96), (80, 0)])
def test_bf16_backward_split_arithmetic(jax_side, terms, D, window):
    """The bfloat16 backward's arithmetic (bfloat16 inputs, o and lse of
    the float32 forward, float32 sums) against ``jax.grad`` of the
    reference's oracle on the same values, both rounded to bfloat16 as
    the kernels' outputs are: three terms within the card test's limits,
    two within chip_smoke.py's, and one rounding of p and ds beyond
    chip_smoke.py's, which is why the kernels split them."""
    jax, jnp = jax_side["jax"], jax_side["jnp"]
    q, k, v, do = (_bf16(t) for t in _t(*_qkv(40, 1, 2, 1, 256, D)))
    o, lse = tref.attention_lse_reference(q, k, v, window=window)
    jct = jnp.asarray(do.numpy())
    want = jax.grad(lambda *a: (jax_side["ref"].attention_reference(
        *a, causal=True, window=window) * jct).sum(), argnums=(0, 1, 2))(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    got = _bf16_backward_emulation(q, k, v, do, o, lse, window, terms)
    rtol, atol, rel_l2 = ((BF16_RTOL, BF16_GRAD_ATOL, BF16_REL_L2["grad"])
                          if terms == 3 else _chip_smoke_limits())
    worst_atol = worst_rel = 0.0
    for a, b in zip(got, want):
        a, b = _bf16(a), _bf16(torch.from_numpy(np.array(b)))
        err = (a - b).abs()
        worst_atol = max(worst_atol, (err - rtol * b.abs()).max().item())
        worst_rel = max(worst_rel, (err.norm() / b.norm()).item())
    within = worst_atol <= atol and worst_rel <= rel_l2
    assert within == (terms > 1), (terms, worst_atol, worst_rel)
    if terms == 1:
        assert worst_atol > 50 * atol and worst_rel > 2 * rel_l2


# ---------------------------------------------------------------------------
# The CUDA kernels (run only where there is a card)
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    """The first CUDA card; skips where there is none (decided here, at
    run time, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


# B, H, Hkv, S, D, window, causal, layout: ragged S, GQA, windows, every
# head dim (80: zamba2-2.7b's shared attention), and the kernels'
# non-causal mode; "mixed" reads q, k, v in the model's layout and do
# contiguous, as autograd may hand it over
CUDA_CASES = [(1, 2, 1, 128, 64, 0, True, "bhsd"),
              (1, 4, 4, 230, 80, 0, True, "bshd"),
              (2, 4, 2, 200, 64, 0, True, "bshd"),
              (1, 8, 2, 300, 128, 40, True, "bhsd"),
              (1, 2, 2, 257, 256, 0, True, "bshd"),
              (2, 9, 1, 190, 128, 96, True, "bshd"),
              (1, 4, 2, 150, 64, 0, False, "bshd"),
              (1, 4, 1, 170, 128, 50, False, "bhsd"),
              (1, 2, 2, 1000, 256, 96, True, "bshd"),
              (1, 9, 1, 1000, 80, 0, True, "bshd"),
              (1, 4, 2, 200, 128, 0, True, "mixed")]


# bfloat16 limits of the card tests: every element within one bfloat16 ulp
# of the value (2^-7 |plain|, the most two roundings of nearly equal
# values differ by) plus an atol for the float32 difference before the
# rounding, and each output within BF16_REL_L2 in the 2-norm.  In the
# backward that difference is summation order and, for the tensor-core
# kernels, their accumulation (the largest reading, 8.4e-7, is dq of the
# D 128 window case); in the forward the kernel rounds the softmax
# weights to bfloat16, an error that scales with the row, so o's atol is
# a share of its row's largest |plain|.  Set at 3-6x the FMA kernels'
# largest readings over CUDA_CASES on an H100
BF16_RTOL = 2.0 ** -7
BF16_O_ROW = 1e-2
BF16_GRAD_ATOL = 1e-6
BF16_REL_L2 = {"o": 1e-2, "grad": 4e-4}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain_versions(cuda_device, dtype):
    """B6, B6f and B6b on the card against their plain versions on the
    card: float32 to float32 summation order (2e-5 * (1 + |plain|)),
    bfloat16 to one bfloat16 rounding of each output plus what precedes
    it (BF16_RTOL, BF16_O_ROW, BF16_GRAD_ATOL, BF16_REL_L2); the float32
    logsumexp to 1e-4 * (1 + |plain|) from bfloat16 inputs."""
    for i, (B, H, Hkv, S, D, window, causal, layout) in enumerate(
            CUDA_CASES):
        q, k, v, do = (t.to(cuda_device, dtype) for t in
                       _t(*_qkv(10 + i, B, H, Hkv, S, D,
                                "bhsd" if layout == "bhsd" else "bshd")))
        if layout != "bhsd":                 # the model's layout, in place
            q, k, v, do = (t.transpose(1, 2) for t in (q, k, v, do))
        if layout == "mixed":
            do = do.contiguous()
        kw = dict(causal=causal, window=window)
        o, lse = tfa.flash_attention_lse(q, k, v, **kw)
        want_o, want_lse = tref.attention_lse_reference(q, k, v, **kw)
        got = [o, lse, tfa.flash_attention(q, k, v, **kw)]
        want = [want_o, want_lse, want_o]
        got += tfa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        want += tref.attention_bwd_reference(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        for name, a, b in zip(("o", "lse", "o", "dq", "dk", "dv"), got,
                              want):
            assert a.shape == b.shape and a.dtype == b.dtype
            a, b = a.float(), b.float()
            err = (a - b).abs()
            if dtype == torch.float32 or name == "lse":
                t = 2e-5 if dtype == torch.float32 else 1e-4
                assert bool((err <= t * (1 + b.abs())).all()), (i, name)
                continue
            if name == "o":
                unit = b.abs().amax(-1, keepdim=True)
                atol, rel_l2 = BF16_O_ROW, BF16_REL_L2["o"]
            else:
                unit, atol, rel_l2 = 1.0, BF16_GRAD_ATOL, BF16_REL_L2["grad"]
            need = ((err - BF16_RTOL * b.abs()) / unit).max().item()
            assert need <= atol, (i, name, need)
            assert err.norm() <= rel_l2 * b.norm(), (
                i, name, (err.norm() / b.norm()).item())


@pytest.mark.cuda
def test_cuda_launch_counts_and_dispatch(cuda_device):
    """Training launches B6f forward and dq + dk/dv backward; without
    autograd the forward is B6; the model's causal attention on CUDA
    tensors goes through them, and ``use_kernel=False`` through none."""
    q, k, v, do = (t.to(cuda_device) for t in
                   _t(*_qkv(20, 2, 4, 2, 96, 64, layout="bshd")))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    tfa.reset_launch_counts()
    out = layers.causal_attention(*leaves, window=30)
    (out * do).sum().backward()
    assert tfa.launch_counts == {tfa.B6: 0, tfa.B6F: 1, tfa.B6_DQ: 1,
                                 tfa.B6_DKV: 1}
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = layers.causal_attention(*plain, window=30, use_kernel=False)
    (want * do).sum().backward()
    assert tfa.launch_counts == {tfa.B6: 0, tfa.B6F: 1, tfa.B6_DQ: 1,
                                 tfa.B6_DKV: 1}
    torch.testing.assert_close(out, want, atol=2e-5, rtol=2e-5)
    for a, b in zip(leaves, plain):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-4, rtol=1e-4)
    with torch.no_grad():
        layers.causal_attention(q, k, v)
    assert tfa.launch_counts[tfa.B6] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("n,rs", [(32, 0), (64, 0), (128, 0), (64, 1),
                                  (80, 1), (128, 1), (256, 1)])
def test_cuda_single_wgmma_matches_matmul(cuda_device, n, rs):
    """One warpgroup's wgmma chain (K 64, four k-steps) from TMA-loaded
    128-byte-swizzled tiles against a float32 matmul: the SS form with
    both operands K-major (as q k^T) and the RS form with A in registers
    and B MN-major (as p v), at every N the kernels use; products of
    bfloat16 values are exact, so only the float32 sums differ."""
    fn = _build.load(tfa.FWD_TC).flash_attention_wgmma_check
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    g = torch.Generator(device=cuda_device)
    g.manual_seed(n + rs)
    a = torch.randn((64, 64), generator=g, device=cuda_device).bfloat16()
    b = torch.randn((64, n) if rs else (n, 64), generator=g,
                    device=cuda_device).bfloat16()
    c = torch.full((64, n), float("nan"), device=cuda_device)
    assert fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), n, rs,
              torch.cuda.current_stream(cuda_device).cuda_stream) == 0
    want = a.float() @ (b.float() if rs else b.float().T)
    torch.testing.assert_close(c, want, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_cuda_tensor_raises_instead_of_falling_back(cuda_device):
    """What the kernels do not take raises on the card: no plain
    fallback, no launch."""
    q, k, v, _ = (t.to(cuda_device) for t in _t(*_qkv(30, 1, 2, 1, 64,
                                                      32)))
    tfa.reset_launch_counts()
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention(q, k, v)             # D = 32
    q, k, v, _ = (t.to(cuda_device) for t in _t(*_qkv(31, 1, 2, 1, 64,
                                                      64)))
    with pytest.raises(TypeError):
        tfa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="contiguous last axis"):
        tfa.flash_attention(q.transpose(2, 3), k, v)
    with pytest.raises(TypeError):
        tfa.flash_attention(q, k.to(torch.bfloat16), v)
    # bfloat16 views TMA cannot read: a base 8 bytes off 16-byte
    # alignment, and a row stride of 68 elements (136 bytes)
    buf = torch.zeros((1, 64, 2 * 64 + 8), device=cuda_device,
                      dtype=torch.bfloat16)
    off = buf[..., 4:4 + 2 * 64].unflatten(-1, (2, 64)).transpose(1, 2)
    bent = torch.zeros((1, 64, 68), device=cuda_device, dtype=torch.bfloat16
                       )[..., :64].unsqueeze(2).transpose(1, 2)
    kb, vb = k.to(torch.bfloat16), v.to(torch.bfloat16)
    for bad in (off, bent):
        with pytest.raises(ValueError, match="16-byte alignment"):
            tfa.flash_attention(bad, kb, vb)
    assert sum(tfa.launch_counts.values()) == 0
