"""The port's pseudo-Voigt fit (the paper's "A" op), its labels and its
synthetic Bragg patches against the reference's.

Inputs are made with numpy from a seed (or by the reference's own
``bragg_patches``, turned into numpy) and fed to both packages: the port's
plain version (``repro_torch.kernels.ref.pseudo_voigt_reference``) is held
to the reference's jnp oracle and to its Pallas kernel in interpret mode at
``atol = rtol = 1e-5``: both run the same float32 arithmetic, summed in
other orders, and differ by at most ~1.4e-6 on these inputs.  The CUDA
kernel itself is held to the plain version on the card; those cases are
marked ``cuda`` and skip where there is no card.  The JAX side is imported
by the tests that use it, so that the CUDA cases also run on a machine
that has no JAX:

    python -m pytest -q --noconftest -m cuda tests/test_torch_pseudo_voigt.py
"""
import numpy as np
import pytest
import torch

from repro_torch.analysis import analyze_patches, label_for_braggnn
from repro_torch.data.synthetic import bragg_patches
from repro_torch.kernels import ops
from repro_torch.kernels import pseudo_voigt as tpv
from repro_torch.kernels import ref as tref

ATOL = RTOL = 1e-5


@pytest.fixture
def jax_side():
    """The reference package's fit (oracle and interpret-mode kernel),
    analysis and synthetic data."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro import analysis as janalysis
    from repro.data.synthetic import bragg_patches as jax_bragg_patches
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    return dict(jax=jax, jnp=jnp, ref=jref.pseudo_voigt_reference,
                kernel=jops.pseudo_voigt_fit, analysis=janalysis,
                bragg_patches=jax_bragg_patches)


def _pv_np(u, gamma):
    """The reference's unit pseudo-Voigt profile, in numpy float32."""
    g2 = gamma * gamma
    lor = g2 / (u * u + g2)
    sig = np.float32(1.0 / np.sqrt(2.0 * np.log(2.0))) * gamma
    gau = np.exp(-(u * u) / (np.float32(2.0) * sig * sig))
    return np.float32(0.5) * lor + np.float32(0.5) * gau


def _noisy_peaks(rng, n, ph=11, pw=11, amp=100.0, noise=0.5):
    """Noisy pV peaks as tests/test_kernels_pv.py builds them: centers in
    [3, 8), gamma in [0.8, 1.8), amplitude 100, noise 0.5."""
    f32 = np.float32
    cy = rng.uniform(3.0, 8.0, n).astype(f32)
    cx = rng.uniform(3.0, 8.0, n).astype(f32)
    g = rng.uniform(0.8, 1.8, n).astype(f32)
    yy = np.arange(ph, dtype=f32)[None, :, None]
    xx = np.arange(pw, dtype=f32)[None, None, :]
    img = (_pv_np(yy - cy[:, None, None], g[:, None, None])
           * _pv_np(xx - cx[:, None, None], g[:, None, None]) * f32(amp))
    return (img + f32(noise) * rng.standard_normal(img.shape).astype(f32))


def _centered_peaks(rng, n, ph, pw, noise):
    """Peaks as the detector hands them over: pre-localized near the
    patch middle, unit-normalized with ``noise`` (as ``bragg_patches``),
    at any (ph, pw)."""
    f32 = np.float32
    cy = ((ph - 1) / 2 + rng.uniform(-1.5, 1.5, n) * min(1, (ph - 1) / 3))
    cx = ((pw - 1) / 2 + rng.uniform(-1.5, 1.5, n) * min(1, (pw - 1) / 3))
    g = rng.uniform(0.8, 1.8, n).astype(f32)[:, None, None]
    yy = np.arange(ph, dtype=f32)[None, :, None]
    xx = np.arange(pw, dtype=f32)[None, None, :]
    img = (_pv_np(yy - cy.astype(f32)[:, None, None], g)
           * _pv_np(xx - cx.astype(f32)[:, None, None], g))
    img = img + f32(noise) * rng.standard_normal(img.shape).astype(f32)
    img = np.clip(img, 0, None)
    return (img / np.maximum(img.max(axis=(1, 2), keepdims=True), 1e-9)
            ).astype(f32)


def _case(name, side):
    rng = np.random.default_rng(0)
    if name == "noisy_peaks":
        return _noisy_peaks(rng, 96)
    if name == "bragg_patches_4096":
        d = side["bragg_patches"](side["jax"].random.PRNGKey(0), 4096)
        return np.array(d["patches"])[..., 0]
    if name == "all_zero":
        return np.zeros((5, 11, 11), np.float32)
    if name == "np7":
        return _noisy_peaks(rng, 7)
    if name == "non_square_9x13":
        return _noisy_peaks(rng, 24, ph=9, pw=13)
    raise KeyError(name)


CASES = ["noisy_peaks", "bragg_patches_4096", "all_zero", "np7",
         "non_square_9x13"]


@pytest.mark.parametrize("name", CASES)
def test_plain_fit_matches_reference_oracle_and_kernel(jax_side, name):
    """The port's plain fit equals the reference's jnp oracle and its
    interpret-mode Pallas kernel on the same patches."""
    p = _case(name, jax_side)
    jp = jax_side["jnp"].asarray(p)
    want_ref = np.asarray(jax_side["ref"](jp))
    want_kernel = np.asarray(jax_side["kernel"](jp, interpret=True))
    got = tref.pseudo_voigt_reference(torch.from_numpy(p)).numpy()
    assert got.shape == (p.shape[0], 6) and got.dtype == np.float32
    np.testing.assert_allclose(got, want_ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, want_kernel, atol=ATOL, rtol=RTOL)
    if name == "all_zero":
        np.testing.assert_array_equal(
            got, np.tile(np.float32([0, 0, 0.5, 0.5, 1e-12, 1e-12]), (5, 1)))


@pytest.mark.parametrize("n_iter", [0, 1, 3])
def test_plain_fit_matches_reference_at_other_iteration_counts(jax_side,
                                                                n_iter):
    p = _noisy_peaks(np.random.default_rng(1), 32)
    want = np.asarray(jax_side["ref"](jax_side["jnp"].asarray(p),
                                      n_iter=n_iter))
    got = tref.pseudo_voigt_reference(torch.from_numpy(p), n_iter).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("ndim", [3, 4])
def test_analysis_and_labels_match_reference(jax_side, ndim):
    """``analyze_patches`` and ``label_for_braggnn`` equal the reference's
    on (N, ph, pw) and (N, ph, pw, 1) input (the port's CPU path)."""
    d = jax_side["bragg_patches"](jax_side["jax"].random.PRNGKey(3), 64)
    p = np.asarray(d["patches"])
    if ndim == 3:
        p = p[..., 0]
    jp = jax_side["jnp"].asarray(p)
    tp = torch.from_numpy(p.copy())
    want = jax_side["analysis"].analyze_patches(jp)
    got = analyze_patches(tp)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=ATOL, rtol=RTOL)
    want_l = np.asarray(jax_side["analysis"].label_for_braggnn(jp))
    got_l = label_for_braggnn(tp).numpy()
    assert got_l.shape == (64, 2)
    np.testing.assert_allclose(got_l, want_l, atol=ATOL, rtol=RTOL)


def test_bragg_patches_shapes_ranges_and_labels():
    """The port's S op: (n, p, p, 1) float32 patches in [0, 1] with max 1,
    centers within the +-1.5 px jitter of the middle, and pseudo-Voigt
    labels within 0.05 of the truth (as tests/test_kernels_pv.py asks of
    the reference's)."""
    g = torch.Generator().manual_seed(0)
    d = bragg_patches(g, 512, device="cpu")
    p, c = d["patches"], d["centers"]
    assert p.shape == (512, 11, 11, 1) and p.dtype == torch.float32
    assert c.shape == (512, 2) and c.dtype == torch.float32
    assert float(p.min()) >= 0.0
    np.testing.assert_allclose(p.amax(dim=(1, 2, 3)).numpy(), 1.0,
                               rtol=1e-6)
    px = c * 10
    assert float((px - 5.0).abs().max()) <= 1.5
    assert float(c.min()) >= 0.0 and float(c.max()) <= 1.0
    labels = label_for_braggnn(p)
    assert float((labels - c).abs().mean()) < 0.05
    # a seeded generator gives the same data; the next draw differs
    again = bragg_patches(torch.Generator().manual_seed(0), 512,
                          device="cpu")
    assert torch.equal(again["patches"], p)
    assert not torch.equal(bragg_patches(g, 512, device="cpu")["patches"], p)


def test_bragg_patches_follow_the_reference_distribution(jax_side):
    """Same distributions as the reference's generator (the bits differ):
    patch statistics and the centers' spread agree to sampling error."""
    n = 4096
    d = jax_side["bragg_patches"](jax_side["jax"].random.PRNGKey(1), n)
    jp, jc = np.asarray(d["patches"]), np.asarray(d["centers"])
    t = bragg_patches(torch.Generator().manual_seed(1), n, device="cpu")
    tp, tc = t["patches"].numpy(), t["centers"].numpy()
    np.testing.assert_allclose(tp.mean(), jp.mean(), rtol=0.03)
    np.testing.assert_allclose(tp.mean(axis=0), jp.mean(axis=0), atol=0.02)
    np.testing.assert_allclose(tc.mean(axis=0), jc.mean(axis=0), atol=0.01)
    np.testing.assert_allclose(tc.std(axis=0), jc.std(axis=0), rtol=0.05)


def test_dispatch_follows_the_device():
    """CPU tensors take the plain version; ``use_kernel=True`` on the CPU
    raises; any Np works, including 0 and 1."""
    p = torch.from_numpy(_noisy_peaks(np.random.default_rng(2), 9))
    want = tref.pseudo_voigt_reference(p)
    torch.testing.assert_close(ops.pseudo_voigt_fit(p), want, atol=0, rtol=0)
    torch.testing.assert_close(ops.pseudo_voigt_fit(p, use_kernel=False),
                               want, atol=0, rtol=0)
    torch.testing.assert_close(tpv.pseudo_voigt_fit(p), want, atol=0, rtol=0)
    with pytest.raises(ValueError, match="CUDA"):
        ops.pseudo_voigt_fit(p, use_kernel=True)
    assert ops.pseudo_voigt_fit(p[:0]).shape == (0, 6)
    torch.testing.assert_close(ops.pseudo_voigt_fit(p[:1]), want[:1])
    assert tpv.launch_counts[tpv.PV] == 0


@pytest.fixture
def cuda_device():
    """The first CUDA card; skips where there is none (decided here, at
    run time, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version(cuda_device):
    """B7 on the card against its plain version on the card: Bragg
    patches at several counts (ragged tails inside and past one block),
    all-zero patches, a non-square, a degenerate (one row) and the
    largest patch; counts launches; refuses what it does not take.

    The fit is only as stable as its input allows: on amplitude-100
    noisy peaks at 32x32 or 1x5 (``_noisy_peaks``) the plain version on
    the card and on the CPU already disagree by up to 2.3 and 0.17.  So
    the kernel is held to the plain version on inputs whose fit is
    stable (checked first: the plain version on the card must match the
    one on the CPU), with peaks as the detector hands them over
    (``_centered_peaks``) at those shapes; on the unstable inputs it
    must give finite fits inside the clamps."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(0)
    cases = [bragg_patches(g, n, device=cuda_device)["patches"][..., 0]
             for n in (1, 7, 128, 129, 4099)]
    cases.append(torch.zeros((8, 11, 11), device=cuda_device))
    rng = np.random.default_rng(0)
    cases.append(torch.from_numpy(_noisy_peaks(rng, 300, 9, 13)).to(
        cuda_device))
    for ph, pw, noise in ((9, 13, 0.01), (1, 5, 0.01), (32, 32, 0.001)):
        cases.append(torch.from_numpy(
            _centered_peaks(rng, 300, ph, pw, noise)).to(cuda_device))
    tpv.reset_launch_counts()
    for p in cases:
        got = ops.pseudo_voigt_fit(p)
        want = ops.pseudo_voigt_fit(p, use_kernel=False)
        torch.cuda.synchronize()
        assert got.shape == (p.shape[0], 6)
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(want.cpu(), tref.pseudo_voigt_reference(
            p.cpu()), atol=ATOL, rtol=RTOL)
        torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
    assert tpv.launch_counts[tpv.PV] == len(cases)
    # the unstable inputs: finite fits inside the clamps
    for ph, pw in ((32, 32), (1, 5)):
        got = ops.pseudo_voigt_fit(torch.from_numpy(
            _noisy_peaks(rng, 300, ph, pw)).to(cuda_device)).cpu()
        assert bool(torch.isfinite(got).all())
        for col, n in ((0, ph), (1, pw)):
            assert float(got[:, col].min()) >= 0.0
            assert float(got[:, col].max()) <= n - 1
            assert float(got[:, 2 + col].min()) >= np.float32(0.3)
            assert float(got[:, 2 + col].max()) <= n
            assert float(got[:, 4 + col].min()) >= np.float32(1e-12)
    assert ops.pseudo_voigt_fit(cases[0][:0]).shape == (0, 6)
    assert tpv.launch_counts[tpv.PV] == len(cases) + 2
    with pytest.raises(ValueError, match="sides"):
        ops.pseudo_voigt_fit(torch.zeros((2, 33, 11), device=cuda_device))
    with pytest.raises(TypeError):
        ops.pseudo_voigt_fit(cases[1].double())
    with pytest.raises(ValueError, match="contiguous"):
        ops.pseudo_voigt_fit(cases[4].transpose(1, 2))
    assert tpv.launch_counts[tpv.PV] == len(cases) + 2
