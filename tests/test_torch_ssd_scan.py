"""The port's SSD scan (B5) against the reference's.

Inputs are made with numpy from a seed and fed to both packages.  On the
CPU the port's plain path (``ops.ssd_scan_heads``, i.e.
``models/ssm.py::ssd_chunked``) is held to the reference's Pallas kernel
in interpret mode on the sweep of ``tests/test_kernels_ssm.py`` at its
tolerance (atol 5e-5, rtol 5e-4: float32 summed in other orders), and the
port's sequential oracle ``ref.ssd_reference`` to the reference's, and
the bf16 tensor-core kernel's roundings, emulated in plain PyTorch, to
the reference's float32 chunked form.  The CUDA kernels are held to the
plain path on the card; those cases are marked ``cuda`` and skip where
there is no card.  The JAX side is
imported by the tests that use it, so that the CUDA cases also run on a
machine that has no JAX:

    python -m pytest -q --noconftest -m cuda tests/test_torch_ssd_scan.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssm_scan as tssd
from repro_torch.models import ssm as tssm

ATOL, RTOL = 5e-5, 5e-4

# tests/test_kernels_ssm.py:21-28 -- B, L, H, P, G, N, chunk
SWEEP = [
    (1, 64, 1, 16, 1, 8, 16),
    (2, 128, 4, 32, 1, 16, 32),
    (2, 128, 4, 32, 2, 16, 64),    # grouped B/C
    (1, 256, 8, 16, 4, 32, 128),
    (1, 96, 2, 24, 2, 8, 32),      # non-pow2 dims
]


@pytest.fixture
def jax_side():
    """The reference package's ops wrapper (its Pallas kernel in
    interpret mode), oracle and model scan."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.models import ssm as jssm
    return dict(jnp=jnp, ops=jops, ref=jref, ssm=jssm)


def _mk(seed, B, L, H, P, G, N):
    """x, dt (softplus'd), A (negative), Bm, Cm as numpy float32, the
    distributions of the reference's kernel tests."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x = f(B, L, H, P) * 0.5
    dt = np.log1p(np.exp(f(B, L, H))).astype(np.float32)
    A = -np.exp(f(H) * 0.3).astype(np.float32)
    return x, dt, A, f(B, L, G, N) * 0.3, f(B, L, G, N) * 0.3


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("B,L,H,P,G,N,chunk", SWEEP)
def test_plain_path_matches_reference_kernel(jax_side, B, L, H, P, G, N,
                                             chunk):
    """ops.ssd_scan_heads on CPU tensors (the plain path) against the
    reference's ops.ssd_scan_heads through its Pallas kernel in
    interpret mode."""
    jnp, jops = jax_side["jnp"], jax_side["ops"]
    arrays = _mk(B + L + H, B, L, H, P, G, N)
    want = jops.ssd_scan_heads(*map(jnp.asarray, arrays), chunk=chunk,
                               interpret=True)
    got = ops.ssd_scan_heads(*_t(*arrays), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("B,L,H,P,G,N,chunk", SWEEP[:3] + SWEEP[4:])
def test_sequential_oracle_matches_reference(jax_side, B, L, H, P, G, N,
                                             chunk):
    """ref.ssd_reference against the reference's, in the kernel layout,
    and the kernel-layout wrapper's CPU path (which is that oracle)
    against the plain chunked path."""
    jnp, jref = jax_side["jnp"], jax_side["ref"]
    x, dt, A, Bm, Cm = _mk(7 + L, B, L, H, P, G, N)
    xdt = np.ascontiguousarray((x * dt[..., None]).transpose(0, 2, 1, 3))
    dA = np.ascontiguousarray((dt * A).transpose(0, 2, 1))
    Bt, Ct = (np.ascontiguousarray(m.transpose(0, 2, 1, 3)) for m in (Bm,
                                                                      Cm))
    want = jref.ssd_reference(*map(jnp.asarray, (xdt, dA, Bt, Ct)))
    got = tref.ssd_reference(*_t(xdt, dA, Bt, Ct))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    wrapped = tssd.ssd_scan(*_t(xdt, dA, Bt, Ct), chunk=chunk)
    chunked = ops.ssd_scan_heads(*_t(x, dt, A, Bm, Cm), chunk=chunk)
    np.testing.assert_allclose(wrapped.transpose(1, 2).numpy(),
                               chunked.numpy(), atol=ATOL, rtol=RTOL)


def test_chunked_form_and_final_state_match_reference(jax_side):
    """models/ssm.py::ssd_chunked with a carried initial state: output
    and final state against the reference's."""
    jnp, jssm = jax_side["jnp"], jax_side["ssm"]
    B, L, H, P, G, N = 2, 64, 4, 16, 2, 8
    arrays = _mk(11, B, L, H, P, G, N)
    s0 = np.random.default_rng(12).standard_normal((B, H, P, N)).astype(
        np.float32)
    jy, jst = jssm.ssd_chunked(*map(jnp.asarray, arrays), chunk=16,
                               init_state=jnp.asarray(s0))
    y, st = tssm.ssd_chunked(*_t(*arrays), chunk=16,
                             init_state=torch.from_numpy(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), atol=ATOL,
                               rtol=RTOL)


def test_chunked_form_gradient_is_finite_where_the_reference_is_nan(
        jax_side):
    """The training path differentiates ssd_chunked.  At the published
    chunk (128) the decays above the diagonal, exp(cum_i - cum_j) with
    cum_i - cum_j up to 127 x dt x |A| (1.6 at the init's bounds),
    overflow float32; the reference masks after the exp, so its gradient
    is NaN (0 x inf), while the port masks before it.  Forward outputs
    agree at the sweep's tolerance and the port's gradients are finite;
    on inputs where nothing overflows both gradients agree to 1e-4."""
    import jax
    jnp, jssm = jax_side["jnp"], jax_side["ssm"]
    B, L, H, P, G, N = 1, 128, 2, 8, 1, 8
    x, dt, A, Bm, Cm = _mk(7, B, L, H, P, G, N)
    for big in (True, False):
        dt_in = np.full_like(dt, 0.1 if big else 0.01)
        A_in = np.full_like(A, -16.0 if big else -1.0)
        arrays = (x, dt_in, A_in, Bm, Cm)

        def jloss(*a):
            return jnp.sum(jssm.ssd_chunked(*a, chunk=128)[0] ** 2)

        jg = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
            *map(jnp.asarray, arrays))
        ts = [t.clone().requires_grad_(True) for t in _t(*arrays)]
        y, _ = tssm.ssd_chunked(*ts, chunk=128)
        jy = jssm.ssd_chunked(*map(jnp.asarray, arrays), chunk=128)[0]
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                                   atol=ATOL, rtol=RTOL)
        tg = torch.autograd.grad((y ** 2).sum(), ts)
        assert all(bool(torch.isfinite(g).all()) for g in tg)
        if big:
            assert any(not np.isfinite(np.asarray(g)).all() for g in jg)
        else:
            for g, want in zip(tg, jg):
                np.testing.assert_allclose(g.numpy(), np.asarray(want),
                                           atol=1e-4, rtol=1e-4)


def test_chunk_invariance():
    """The result does not depend on the chunking."""
    arrays = _t(*_mk(13, 1, 128, 2, 16, 1, 8))
    y1 = ops.ssd_scan_heads(*arrays, chunk=16)
    y2 = ops.ssd_scan_heads(*arrays, chunk=128)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=ATOL, rtol=RTOL)


def test_decode_step_matches_scan():
    """The recurrent decode step reproduces the chunked scan's last
    output and final state (tests/test_kernels_ssm.py's check)."""
    B, L, H, P, G, N = 2, 32, 2, 16, 1, 8
    x, dt, A, Bm, Cm = _t(*_mk(14, B, L, H, P, G, N))
    y_scan, final = tssm.ssd_chunked(x, dt, A, Bm, Cm, chunk=8)
    state = torch.zeros((B, H, P, N))
    for t in range(L):
        state, y_t = tssm.ssd_decode_step(state, x[:, t], dt[:, t], A,
                                          Bm[:, t], Cm[:, t])
    np.testing.assert_allclose(y_t.numpy(), y_scan[:, -1].numpy(),
                               atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(state.numpy(), final.numpy(), atol=1e-4,
                               rtol=1e-3)


def test_cpu_dispatch():
    """CPU tensors take the plain path and launch nothing; use_kernel=True
    on them raises, and a chunk that does not divide L raises."""
    arrays = _t(*_mk(15, 1, 32, 2, 8, 1, 8))
    tssd.reset_launch_counts()
    ops.ssd_scan_heads(*arrays, chunk=16)
    assert tssd.launch_counts[tssd.SSD] == 0
    with pytest.raises(ValueError, match="CUDA"):
        ops.ssd_scan_heads(*arrays, chunk=16, use_kernel=True)
    with pytest.raises(ValueError, match="multiple"):
        ops.ssd_scan_heads(*arrays, chunk=12)


# ---------------------------------------------------------------------------
# The tensor-core kernel's arithmetic (bf16 inputs), emulated on the CPU
# ---------------------------------------------------------------------------
def _bf(x):
    """float32 values rounded to bf16 (kept as float32)."""
    return x.bfloat16().float()


def _emulate_tc(x, dt, A, Bm, Cm, chunk):
    """The bf16 kernel's arithmetic (csrc/ssm_scan_tc.cu) in plain
    PyTorch: x, Bm, Cm (B, L, ., .) bf16 values, dt and A float32, handed
    over as ``ops.ssd_scan_heads`` hands them (xdt = x * dt rounded to
    bf16, dA = dt * A).  Per chunk: W = (C B^T) o exp(cum_i - cum_j) for
    j <= i, rounded to bf16; y = exp(cum_i) (C bf16(S)^T) + W xdt in
    float32, rounded to bf16; the decay exp(cum_last - cum_j) and B o decay
    rounded to bf16; S = exp(cum_last) S + xdt^T (B o decay) in float32."""
    B, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(chunk, L)
    rep = H // G
    xdt = _bf(x * _bf(dt)[..., None])
    dA = dt * A
    Bh = torch.repeat_interleave(Bm, rep, dim=2)
    Ch = torch.repeat_interleave(Cm, rep, dim=2)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
    S = torch.zeros((B, H, P, N))
    ys = []
    for c in range(L // Q):
        sl = slice(c * Q, (c + 1) * Q)
        xc, bc, cc = (t[:, sl].transpose(1, 2) for t in (xdt, Bh, Ch))
        cum = torch.cumsum(dA[:, sl].transpose(1, 2), dim=-1)    # (B, H, Q)
        diff = torch.where(tri, cum[..., :, None] - cum[..., None, :], 0.)
        W = _bf(torch.where(tri, (cc @ bc.transpose(-1, -2))
                            * torch.exp(diff), 0.))
        y = torch.exp(cum)[..., None] * (cc @ _bf(S).transpose(-1, -2)) \
            + W @ xc
        ys.append(_bf(y).transpose(1, 2))
        last = cum[..., -1:]
        dec = _bf(torch.exp(last - cum))
        S = torch.exp(last)[..., None] * S \
            + xc.transpose(-1, -2) @ _bf(bc * dec[..., None])
    return torch.cat(ys, dim=1)


# the emulation against the reference's float32 chunked form on the same
# bf16-valued inputs: the roundings of xdt, W, the decays, B o decay, S and
# the output are the whole difference.  Readings over SWEEP: rel_l2 at most
# 3.5e-3, max err at most 7.8e-3 x max |reference|; the plain bf16 path,
# which also rounds its products' outputs, reads 3.9e-3 and 7.8e-3
EMU_REL_L2 = 1e-2
EMU_MAX = 2e-2


@pytest.mark.parametrize("B,L,H,P,G,N,chunk", SWEEP)
def test_tensor_core_arithmetic_matches_reference(jax_side, B, L, H, P, G, N,
                                                  chunk):
    """The bf16 kernel's roundings (:func:`_emulate_tc`) against the
    reference's chunked SSD in float32 on bf16-valued inputs: the whole
    within EMU_REL_L2 in the 2-norm, every element within EMU_MAX x the
    largest |reference|."""
    jnp, jssm = jax_side["jnp"], jax_side["ssm"]
    x, dt, A, Bm, Cm = _mk(40 + L + P, B, L, H, P, G, N)
    x, Bm, Cm = (_bf(torch.from_numpy(a)).numpy() for a in (x, Bm, Cm))
    want = torch.from_numpy(np.array(jssm.ssd_chunked(
        *map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk=chunk)[0]))
    got = _emulate_tc(*_t(x, dt, A, Bm, Cm), chunk)
    err = got - want
    assert bool(torch.isfinite(got).all())
    assert err.norm() <= EMU_REL_L2 * want.norm(), (
        (err.norm() / want.norm()).item())
    assert err.abs().max() <= EMU_MAX * want.abs().max(), (
        (err.abs().max() / want.abs().max()).item())
    assert err.abs().max() > 0       # the roundings are there


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


# B, L, H, P, G, N, chunk: zamba2-2.7b's heads (H 80, P 64, N 64, chunk
# 128) at a shorter L, groups, widths that are no multiple of 16, a chunk
# of L < 128 and the widest P and N the kernel takes
CUDA_CASES = [(1, 512, 80, 64, 1, 64, 128),
              (2, 256, 8, 32, 2, 16, 64),
              (1, 96, 6, 24, 3, 40, 32),
              (2, 48, 4, 64, 1, 64, 128),
              (1, 256, 2, 128, 1, 128, 64)]
# float32 kernel (FMA) against float32 plain: the same arithmetic in
# another order; bfloat16 (the tensor-core kernel): both round W, the
# decays exp(cum_last - cum_j), B o decay and the carried state to
# bfloat16 before their products, but the plain path also rounds each
# product's output (and exp(cum_i)) and the kernel keeps them in float32,
# so they differ by a few bfloat16 roundings of the output: a relative
# 2-norm limit for the whole and a per-element limit relative to the
# output's largest |value|
# Largest readings over CUDA_CASES on an H100 (the test prints them):
# float32 err / (1 + |plain|) 9.3e-8; bfloat16 rel_l2 2.1e-3, max err /
# max |plain| 4.3e-3 (the FMA kernel, which rounded nothing, read 3.0e-3
# and 4.7e-3).
F32_TOL = 2e-6
BF16_REL_L2 = 1e-2
BF16_MAX = 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain_path(cuda_device, dtype):
    """B5 on the card against the plain path on the card, on the same
    inputs (float32: F32_TOL * (1 + |plain|); bfloat16: BF16_REL_L2 and
    BF16_MAX x max |plain|), in the model layout the path hands over; the
    bf16 kernel returns the same bits twice (it has no atomics)."""
    for i, (B, L, H, P, G, N, chunk) in enumerate(CUDA_CASES):
        x, dt, A, Bm, Cm = (t.to(cuda_device) for t in
                            _t(*_mk(20 + i, B, L, H, P, G, N)))
        x, Bm, Cm = x.to(dtype), Bm.to(dtype), Cm.to(dtype)
        got = ops.ssd_scan_heads(x, dt, A, Bm, Cm, chunk=chunk,
                                 use_kernel=True)
        want = ops.ssd_scan_heads(x, dt, A, Bm, Cm, chunk=chunk,
                                  use_kernel=False)
        if dtype == torch.bfloat16:
            assert torch.equal(got, ops.ssd_scan_heads(
                x, dt, A, Bm, Cm, chunk=chunk, use_kernel=True)), i
        torch.cuda.synchronize()
        assert got.dtype == want.dtype == dtype
        a, b = got.float(), want.float()
        err = (a - b).abs()
        print(f"B5 {dtype} case {i}: err/(1+|plain|) "
              f"{(err / (1 + b.abs())).max().item():.2e} rel_l2 "
              f"{(err.norm() / b.norm()).item():.2e} max/max|plain| "
              f"{(err.max() / b.abs().max()).item():.2e}")
        assert bool(torch.isfinite(a).all()), i
        if dtype == torch.float32:
            assert bool((err <= F32_TOL * (1 + b.abs())).all()), (
                i, err.max().item())
        else:
            assert err.max() <= BF16_MAX * b.abs().max(), (
                i, (err.max() / b.abs().max()).item())
            assert err.norm() <= BF16_REL_L2 * b.norm(), (
                i, (err.norm() / b.norm()).item())


@pytest.mark.cuda
def test_cuda_launch_counts_and_refusals(cuda_device):
    """The kernel path launches B5 once a call, the plain path none;
    inputs that require grad under grad mode raise, as do shapes the
    kernel does not take; nothing falls back."""
    x, dt, A, Bm, Cm = (t.to(cuda_device) for t in
                        _t(*_mk(30, 1, 64, 4, 16, 1, 16)))
    tssd.reset_launch_counts()
    ops.ssd_scan_heads(x, dt, A, Bm, Cm, chunk=32)
    ops.ssd_scan_heads(x, dt, A, Bm, Cm, chunk=32, use_kernel=False)
    assert tssd.launch_counts[tssd.SSD] == 1
    with pytest.raises(RuntimeError, match="no backward"):
        ops.ssd_scan_heads(x.requires_grad_(True), dt, A, Bm, Cm, chunk=32)
    x = x.detach()
    with pytest.raises(ValueError, match="chunk"):
        ops.ssd_scan_heads(x, dt, A, Bm, Cm, chunk=48)
    with pytest.raises(TypeError):
        tssd.ssd_scan(x.transpose(1, 2).half(), (dt * A).transpose(1, 2),
                      Bm.transpose(1, 2).half(), Cm.transpose(1, 2).half())
    assert tssd.launch_counts[tssd.SSD] == 1


@pytest.mark.cuda
def test_cuda_bf16_runs_the_tensor_core_kernel(cuda_device, monkeypatch):
    """bf16 inputs launch the tensor-core library (csrc/ssm_scan_tc.cu),
    float32 ones the FMA library, once a call each; a bf16 view whose rows
    do not start on 16 bytes raises instead of falling back."""
    used = []
    lib = tssd._lib
    monkeypatch.setattr(tssd, "_lib", lambda name: used.append(name)
                        or lib(name))
    x, dt, A, Bm, Cm = (t.to(cuda_device) for t in
                        _t(*_mk(31, 1, 64, 4, 16, 1, 16)))
    tssd.reset_launch_counts()
    ops.ssd_scan_heads(x.bfloat16(), dt, A, Bm.bfloat16(), Cm.bfloat16(),
                       chunk=32)
    assert used == [tssd.SRC_TC]
    ops.ssd_scan_heads(x, dt, A, Bm, Cm, chunk=32)
    assert used == [tssd.SRC_TC, tssd.SRC]
    assert tssd.launch_counts[tssd.SSD] == 2
    xdt = (x * dt[..., None]).bfloat16().transpose(1, 2)
    dA = (dt * A).transpose(1, 2)
    Bt, Ct = (m.bfloat16().transpose(1, 2) for m in (Bm, Cm))
    wide = torch.zeros((1, 4, 64, 20), dtype=torch.bfloat16,
                       device=cuda_device)
    wide[..., :16] = xdt
    with pytest.raises(ValueError, match="16 bytes"):
        tssd.ssd_scan(wide[..., 2:18], dA, Bt, Ct, chunk=32)
    with pytest.raises(ValueError, match="16 bytes"):
        tssd.ssd_scan(wide[..., :16], dA, Bt, Ct, chunk=32)
    assert tssd.launch_counts[tssd.SSD] == 2
    torch.testing.assert_close(
        tssd.ssd_scan(xdt.contiguous(), dA, Bt, Ct, chunk=32).float(),
        tssd.ssd_scan(xdt, dA, Bt, Ct, chunk=32).float(), atol=0, rtol=0)
