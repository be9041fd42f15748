"""The port's chunkwise mLSTM (B4) against the reference's.

Inputs are made with numpy from a seed and fed to both packages.  On the
CPU the port's plain path (``ops.mlstm_scan_heads``, i.e.
``models/xlstm.py::mlstm_chunkwise``) is held to the reference's Pallas
kernel in interpret mode on the sweep of ``tests/test_kernels_mlstm.py``
at its tolerance (atol 2e-4, rtol 2e-3), to the reference's chunkwise
form with its final state, and to the sequential decode recurrence.  The
CUDA kernel is held to the plain path on the card; those cases are
marked ``cuda`` and skip where there is no card.  The JAX side is
imported by the tests that use it, so that the CUDA cases also run on a
machine that has no JAX:

    python -m pytest -q --noconftest -m cuda tests/test_torch_mlstm_scan.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import mlstm_scan as tml
from repro_torch.kernels import ops
from repro_torch.models import xlstm as txl

ATOL, RTOL = 2e-4, 2e-3

# tests/test_kernels_mlstm.py:21-26 -- B, L, H, hd, chunk
SWEEP = [
    (1, 64, 1, 16, 16),
    (2, 128, 2, 32, 32),
    (2, 128, 4, 64, 64),
    (1, 96, 2, 24, 32),     # non-pow2 dims
]


@pytest.fixture
def jax_side():
    """The reference package's ops wrapper (its Pallas kernel in
    interpret mode) and model forms."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.models import xlstm as jxl
    return dict(jnp=jnp, ops=jops, xl=jxl)


def _mk(seed, B, L, H, hd):
    """q, k, v, log_i, log_f as numpy float32, the distributions of the
    reference's kernel tests (log_f = log_sigmoid(normal + 2))."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k, v = f(B, L, H, hd) * 0.5, f(B, L, H, hd) * 0.5, f(B, L, H, hd) * 0.5
    log_i = f(B, L, H) * 0.5
    log_f = -np.log1p(np.exp(-(f(B, L, H) + 2.0))).astype(np.float32)
    return q, k, v, log_i, log_f


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("B,L,H,hd,chunk", SWEEP)
def test_plain_path_matches_reference_kernel(jax_side, B, L, H, hd, chunk):
    """ops.mlstm_scan_heads on CPU tensors (the plain path) against the
    reference's ops.mlstm_scan_heads through its Pallas kernel in
    interpret mode."""
    jnp, jops = jax_side["jnp"], jax_side["ops"]
    arrays = _mk(B + L + hd, B, L, H, hd)
    want = jops.mlstm_scan_heads(*map(jnp.asarray, arrays), chunk=chunk,
                                 interpret=True)
    got = ops.mlstm_scan_heads(*_t(*arrays), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("B,L,H,hd,chunk", SWEEP[1:])
def test_chunkwise_form_and_state_match_reference(jax_side, B, L, H, hd,
                                                  chunk):
    """models/xlstm.py::mlstm_chunkwise: output and final (C, n, m)
    against the reference's, and the kernel-layout wrapper's CPU path
    against the model layout."""
    jnp, jxl = jax_side["jnp"], jax_side["xl"]
    arrays = _mk(3 + L, B, L, H, hd)
    jh, jst = jxl.mlstm_chunkwise(*map(jnp.asarray, arrays), chunk)
    h, st = txl.mlstm_chunkwise(*_t(*arrays), chunk)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=ATOL,
                               rtol=RTOL)
    for a, b in zip(st, jst):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=RTOL)
    wrapped = tml.mlstm_scan(*(t.transpose(1, 2) for t in _t(*arrays)),
                             chunk=chunk)
    np.testing.assert_allclose(wrapped.transpose(1, 2).numpy(), h.numpy(),
                               atol=ATOL, rtol=RTOL)


def test_plain_path_matches_sequential_recurrence():
    """The chunkwise form against the decode step run token by token
    (tests/test_kernels_mlstm.py's check)."""
    B, L, H, hd = 1, 32, 2, 16
    q, k, v, li, lf = _t(*_mk(4, B, L, H, hd))
    h = ops.mlstm_scan_heads(q, k, v, li, lf, chunk=8)
    state = (torch.zeros((B, H, hd, hd)), torch.zeros((B, H, hd)),
             torch.full((B, H), -1e30))
    outs = []
    for t in range(L):
        state, h_t = txl.mlstm_decode_step(state, q[:, t], k[:, t], v[:, t],
                                           li[:, t], lf[:, t])
        outs.append(h_t)
    np.testing.assert_allclose(h.numpy(), torch.stack(outs, 1).numpy(),
                               atol=ATOL, rtol=RTOL)


def test_chunk_invariance():
    """The result does not depend on the chunking."""
    arrays = _t(*_mk(5, 1, 64, 2, 16))
    h1 = ops.mlstm_scan_heads(*arrays, chunk=8)
    h2 = ops.mlstm_scan_heads(*arrays, chunk=64)
    np.testing.assert_allclose(h1.numpy(), h2.numpy(), atol=ATOL, rtol=RTOL)


def test_cpu_dispatch():
    """CPU tensors take the plain path and launch nothing; use_kernel=True
    on them raises."""
    arrays = _t(*_mk(6, 1, 32, 2, 16))
    tml.reset_launch_counts()
    ops.mlstm_scan_heads(*arrays, chunk=16)
    assert tml.launch_counts[tml.MLSTM] == 0
    with pytest.raises(ValueError, match="CUDA"):
        ops.mlstm_scan_heads(*arrays, chunk=16, use_kernel=True)


# ---------------------------------------------------------------------------
# The tensor-core kernel's arithmetic (bf16 inputs), emulated on the CPU
# ---------------------------------------------------------------------------
def _bf(x):
    """float32 values rounded to bf16 (kept as float32)."""
    return x.bfloat16().float()


def _split(x):
    """x as a bf16 hi + lo pair, each kept as float32."""
    hi = _bf(x)
    return hi, _bf(x - hi)


def _emulate_tc(q, k, v, li, lf, chunk):
    """The bf16 kernel's arithmetic (csrc/mlstm_scan_tc.cu) in plain
    PyTorch: q/k/v (B, L, H, hd) bf16 values, gates float32.  Per chunk:
    q * scale rounded to bf16; raw scores in float32; S gated in float32,
    its row sums taken there, then rounded to bf16 before S v; C rounded
    to bf16 before q C; n and ks as bf16 hi + lo pairs; the C update k^T
    (ks o v) with ks o v as a hi + lo pair; the state (C, n) and the
    stabilizer in float32, C = decay C + upd."""
    B, L, H, hd = q.shape
    Q = min(chunk, L)
    nc = L // Q
    neg = -1e30
    qs = _bf(q * (1.0 / hd ** 0.5))
    C = torch.zeros((B, H, hd, hd))
    n = torch.zeros((B, H, hd))
    m = torch.full((B, H), neg)
    hs = []
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
    for c in range(nc):
        sl = slice(c * Q, (c + 1) * Q)
        qc, kc, vc = (t[:, sl].transpose(1, 2) for t in (qs, k, v))
        lic, lfc = li[:, sl].transpose(1, 2), lf[:, sl].transpose(1, 2)
        b = torch.cumsum(lfc, dim=-1)                      # (B, H, Q)
        bQ = b[..., -1]
        umax = ((bQ[..., None] - b) + lic).amax(-1)
        m_new = torch.maximum(bQ + m, umax)
        w = (b[..., :, None] - b[..., None, :]) + lic[..., None, :]
        w = torch.where(tri, w, torch.tensor(neg))
        m_pos = torch.maximum(w.amax(-1), b + m[..., None])
        S = torch.where(tri, (qc @ kc.transpose(-1, -2))
                        * torch.exp(w - m_pos[..., None]), torch.tensor(0.))
        den = S.sum(-1)
        iw = torch.exp((b + m[..., None]) - m_pos)
        n_hi, n_lo = _split(n)
        qn = (qc @ n_hi[..., None])[..., 0] + (qc @ n_lo[..., None])[..., 0]
        num = _bf(S) @ vc + iw[..., None] * (qc @ _bf(C))
        denom = torch.maximum((den + iw * qn).abs(), torch.exp(-m_pos))
        hs.append(_bf(num / denom[..., None]).transpose(1, 2))
        ks = torch.exp(((bQ[..., None] - b) + lic) - m_new[..., None])
        v_hi, v_lo = _split(ks[..., None] * vc)
        ks_hi, ks_lo = _split(ks)
        decay = torch.exp((bQ + m) - m_new)
        kt = kc.transpose(-1, -2)
        C = decay[..., None, None] * C + (kt @ v_hi + kt @ v_lo)
        n = decay[..., None] * n + ((kt @ ks_hi[..., None])[..., 0]
                                    + (kt @ ks_lo[..., None])[..., 0])
        m = m_new
    return torch.cat(hs, dim=1)


# the emulation against the reference's float32 chunkwise form on the
# same bf16-valued inputs: the roundings of q * scale (exact where
# 1/sqrt(hd) is a power of two), of S and C before their products and of
# the output are the whole difference.  Readings over SWEEP: rel_l2 at
# most 3.0e-3, max err at most 4.3e-3 x max |reference|; the plain bf16
# path, which also rounds its products' outputs, reads 3.6e-3 and 6.6e-3
EMU_REL_L2 = 1e-2
EMU_MAX = 2e-2


@pytest.mark.parametrize("B,L,H,hd,chunk", SWEEP)
def test_tensor_core_arithmetic_matches_reference(jax_side, B, L, H, hd,
                                                  chunk):
    """The bf16 kernel's roundings (:func:`_emulate_tc`) against the
    reference's chunkwise mLSTM in float32 on bf16-valued inputs: the
    whole within EMU_REL_L2 in the 2-norm, every element within EMU_MAX x
    the largest |reference|."""
    jnp, jxl = jax_side["jnp"], jax_side["xl"]
    q, k, v, li, lf = _mk(40 + hd, B, L, H, hd)
    q, k, v = (_bf(torch.from_numpy(a)).numpy() for a in (q, k, v))
    want = torch.from_numpy(np.array(jxl.mlstm_chunkwise(
        *map(jnp.asarray, (q, k, v, li, lf)), chunk)[0]))
    got = _emulate_tc(*_t(q, k, v, li, lf), chunk)
    err = got - want
    assert bool(torch.isfinite(got).all())
    assert err.norm() <= EMU_REL_L2 * want.norm(), (
        (err.norm() / want.norm()).item())
    assert err.abs().max() <= EMU_MAX * want.abs().max(), (
        (err.abs().max() / want.abs().max()).item())
    assert err.abs().max() > 0       # the roundings are there


# ---------------------------------------------------------------------------
# The CUDA kernel (run only where there is a card)
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    """The first CUDA card; skips where there is none (decided here, at
    run time, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


# B, L, H, hd, chunk: xlstm-1.3b's heads (H 4, hd 1024, chunk 128) at a
# shorter L, the smoke config's hd 128, widths that are no multiple of 32
# and a chunk of L < 128
CUDA_CASES = [(1, 512, 4, 1024, 128),
              (2, 256, 4, 128, 128),
              (1, 96, 2, 24, 32),
              (2, 48, 3, 80, 128)]
# float32 kernel (FMA) against float32 plain: the same arithmetic in
# another order; bfloat16 (the tensor-core kernel): both round q / sqrt(hd),
# the gated scores and the carried C to bfloat16 before their products,
# but the plain path also rounds each product's output and the kernel
# keeps them in float32 (and carries the C update's operand as a bf16
# hi + lo pair), so they differ by a few bfloat16 roundings of the
# output: a relative 2-norm limit for the whole and a per-element limit
# relative to the output's largest |value|
# Largest readings over CUDA_CASES on an H100 (the test prints them):
# float32 err / (1 + |plain|) 3.5e-7; bfloat16 rel_l2 3.6e-3, max err /
# max |plain| 7.1e-3 (the FMA kernel read 4.0e-3 and 6.5e-3).
F32_TOL = 2e-6
BF16_REL_L2 = 1e-2
BF16_MAX = 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain_path(cuda_device, dtype):
    """B4 on the card against the plain path on the card, on the same
    inputs (float32: F32_TOL * (1 + |plain|); bfloat16: BF16_REL_L2 and
    BF16_MAX x max |plain|), in the model layout the path hands over; the
    bf16 kernel returns the same bits twice (it has no atomics)."""
    for i, (B, L, H, hd, chunk) in enumerate(CUDA_CASES):
        q, k, v, li, lf = (t.to(cuda_device) for t in
                           _t(*_mk(20 + i, B, L, H, hd)))
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        got = ops.mlstm_scan_heads(q, k, v, li, lf, chunk=chunk,
                                   use_kernel=True)
        want = ops.mlstm_scan_heads(q, k, v, li, lf, chunk=chunk,
                                    use_kernel=False)
        if dtype == torch.bfloat16:
            assert torch.equal(got, ops.mlstm_scan_heads(
                q, k, v, li, lf, chunk=chunk, use_kernel=True)), i
        torch.cuda.synchronize()
        assert got.dtype == want.dtype == dtype
        a, b = got.float(), want.float()
        err = (a - b).abs()
        print(f"B4 {dtype} case {i}: err/(1+|plain|) "
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
    """The kernel path launches B4 once a call, the plain path none;
    inputs that require grad under grad mode raise, as do shapes the
    kernel does not take; nothing falls back."""
    q, k, v, li, lf = (t.to(cuda_device) for t in _t(*_mk(30, 1, 64, 2,
                                                           32)))
    tml.reset_launch_counts()
    ops.mlstm_scan_heads(q, k, v, li, lf, chunk=32)
    ops.mlstm_scan_heads(q, k, v, li, lf, chunk=32, use_kernel=False)
    assert tml.launch_counts[tml.MLSTM] == 1
    with pytest.raises(RuntimeError, match="no backward"):
        ops.mlstm_scan_heads(q.requires_grad_(True), k, v, li, lf, chunk=32)
    q = q.detach()
    with pytest.raises(ValueError, match="chunk"):
        ops.mlstm_scan_heads(q, k, v, li, lf, chunk=48)
    with pytest.raises(TypeError):
        ops.mlstm_scan_heads(q.half(), k.half(), v.half(), li, lf)
    assert tml.launch_counts[tml.MLSTM] == 1
