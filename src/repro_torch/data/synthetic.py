"""Synthetic experiment data -- the paper's "S"(imulate) op -- and
synthetic LM token batches.

The counterpart of ``repro/data/synthetic.py``:

* Bragg-peak patches (HEDM): pseudo-Voigt peaks on a noisy background
  whose ground-truth centers play the role of physics; the conventional
  "A" op (``analysis/pseudo_voigt.py``) recovers them to label BraggNN's
  training data, the paper's pipeline.
* CookieBox eToF shots: 16 channels of photo-electron energy histograms
  whose underlying smooth pdf is CookieNetAE's regression target.
* LM token batches with a learnable bigram structure.

Randomness comes from an explicit ``torch.Generator`` on the output's
device, so the values differ from ``jax.random``'s; the distributions and
the rendering are the reference's.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.ref import pv_profile


def _uniform(generator: torch.Generator, shape: Tuple[int, ...], lo: float,
             hi: float, device: torch.device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device)
    return lo + (hi - lo) * u


def bragg_patches(generator: torch.Generator, n: int, patch: int = 11, *,
                  noise: float = 0.01, amp_range=(0.5, 2.0),
                  gamma_range=(0.8, 1.8), jitter: float = 1.5,
                  device="cuda") -> Dict[str, torch.Tensor]:
    """Returns {"patches": (n, p, p, 1) float32 in [0, 1], "centers":
    (n, 2) float32 in [0, 1]} on ``device`` (the generator's device).

    Peak centers are uniform within +-``jitter`` px of the patch center
    (peaks are pre-localized by the detector's coarse maximum search).
    Each patch is amplitude x pV(y) x pV(x) plus Gaussian noise, clipped at
    0 and normalized to a maximum of 1, like the BraggNN reference.
    """
    dev = resolve_device(device)
    mid = (patch - 1) / 2.0
    centers = mid + _uniform(generator, (n, 2), -jitter, jitter, dev)
    amps = _uniform(generator, (n,), amp_range[0], amp_range[1], dev)
    gammas = _uniform(generator, (n,), gamma_range[0], gamma_range[1], dev)
    grid = torch.arange(patch, dtype=torch.float32, device=dev)
    g = gammas[:, None]
    py = pv_profile(grid[None, :] - centers[:, 0:1], g)      # (n, p)
    px = pv_profile(grid[None, :] - centers[:, 1:2], g)
    img = amps[:, None, None] * py[:, :, None] * px[:, None, :]
    img = img + noise * torch.randn(img.shape, generator=generator,
                                    device=dev)
    img = torch.clamp(img, min=0.0)
    mx = img.amax(dim=(1, 2), keepdim=True)
    img = img / torch.clamp(mx, min=1e-9)
    return {"patches": img[..., None],
            "centers": centers / (patch - 1)}


# ---------------------------------------------------------------------------
def cookiebox_pdf(line_pos: torch.Tensor, line_w: torch.Tensor,
                  phase: torch.Tensor, strength: torch.Tensor,
                  channels: int = 16, bins: int = 128) -> torch.Tensor:
    """The deterministic part of :func:`cookiebox_shots`: the pdf of each
    shot's lines, (n, channels, bins) float32 on the draws' device.

    Each of a shot's lines (the draws are (n, lines)) has a Gaussian
    spectral profile at ``line_pos`` of width ``line_w`` and an intensity
    that varies with the detector angle theta as 0.5 (1 + cos(theta -
    phase)) (the circular-polarization signature), weighted by
    ``strength``; the sum over lines is normalized along the bins (with a
    1e-9 floor)."""
    dev = line_pos.device
    theta = torch.arange(channels, dtype=torch.float32, device=dev) * (
        2 * math.pi / channels)
    x = torch.arange(bins, dtype=torch.float32, device=dev)
    ang = 0.5 * (1 + torch.cos(theta[None, :, None]
                               - phase[:, None, :]))   # (n, ch, l)
    gaus = torch.exp(-(x[None, None, :] - line_pos[:, :, None]) ** 2
                     / (2 * line_w[:, :, None] ** 2))   # (n, l, bins)
    pdf = torch.einsum("nl,ncl,nlb->ncb", strength, ang, gaus)
    return pdf / torch.clamp(pdf.sum(dim=-1, keepdim=True), min=1e-9)


def cookiebox_shots(generator: torch.Generator, n: int, channels: int = 16,
                    bins: int = 128, *, counts: int = 200,
                    device="cuda") -> Dict[str, torch.Tensor]:
    """Returns {"images": (n, ch, bins, 1) histograms, "targets": the
    same shape, the pdf}, float32 on ``device`` (the generator's device).

    Physics stand-in: each shot has 3 spectral lines (positions uniform
    in [10, bins - 10], widths in [2, 6], phases in [0, 2 pi], strengths
    in [0.2, 1]) whose pdf is :func:`cookiebox_pdf`; the image is a
    low-count Poisson draw of ``counts`` x pdf normalized by its sum (at
    least 1), the hard regime the paper mentions ("number of detected
    electrons is low")."""
    dev = resolve_device(device)
    shape = (n, 3)
    line_pos = _uniform(generator, shape, 10.0, bins - 10.0, dev)
    line_w = _uniform(generator, shape, 2.0, 6.0, dev)
    phase = _uniform(generator, shape, 0.0, 2 * math.pi, dev)
    strength = _uniform(generator, shape, 0.2, 1.0, dev)
    pdf = cookiebox_pdf(line_pos, line_w, phase, strength, channels, bins)
    hist = torch.poisson(counts * pdf, generator=generator)
    hist = hist / torch.clamp(hist.sum(dim=-1, keepdim=True), min=1.0)
    return {"images": hist[..., None], "targets": pdf[..., None]}


# ---------------------------------------------------------------------------
def lm_token_recurrence(start: torch.Tensor, noise: torch.Tensor,
                        vocab: int) -> Dict[str, torch.Tensor]:
    """The bigram recurrence of :func:`lm_token_batch` from its random
    draws: start (B, 1) in [0, vocab) and noise (B, S) in {0, 1, 2} give
    tokens x_{t+1} = (31 x_t + 7 + noise_t) mod vocab (B, S), x_0 = start
    excluded, and the next-token labels, -1 at the last position.  Both
    int64 on the draws' device."""
    x = start[:, 0].long()
    cols = []
    for n in noise.long().unbind(dim=1):
        x = (31 * x + 7 + n) % vocab
        cols.append(x)
    tokens = torch.stack(cols, dim=1)
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    labels[:, -1] = -1                  # no target for the last position
    return {"tokens": tokens, "labels": labels}


def lm_token_batch(generator: torch.Generator, batch: int, seq: int,
                   vocab: int, *, device="cuda") -> Dict[str, torch.Tensor]:
    """Synthetic next-token LM batch with a learnable bigram structure:
    {"tokens", "labels"} (batch, seq) int64 on ``device``.  The draws come
    from ``generator`` (its own device) and the recurrence runs there;
    a CPU generator keeps the sequential recurrence off the card."""
    dev = resolve_device(device)
    start = torch.randint(0, vocab, (batch, 1), generator=generator,
                          device=generator.device)
    noise = torch.randint(0, 3, (batch, seq), generator=generator,
                          device=generator.device)
    out = lm_token_recurrence(start, noise, vocab)
    return {k: v.to(dev) for k, v in out.items()}
