"""The conventional "A"(nalyze) operation: pseudo-Voigt Bragg-peak fitting.

The counterpart of ``repro/analysis/pseudo_voigt.py``: the compute step the
paper's ML surrogate replaces (BraggNN predicts what this produces).  The
fit goes through ``kernels/ops.py``: the Hopper kernel for CUDA tensors,
the plain PyTorch version for CPU tensors (``use_kernel`` pins either).

Output: per-patch peak centers (y0, x0) in pixels + fit diagnostics.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import ops as kernel_ops


def analyze_patches(patches: torch.Tensor, *, n_iter: int = 5,
                    use_kernel: Optional[bool] = None
                    ) -> Dict[str, torch.Tensor]:
    """patches: (N, ph, pw) or (N, ph, pw, 1) -> dict of fit results:
    ``centers_px`` (N, 2) as (y0, x0), ``gammas`` and ``amplitudes``."""
    if patches.dim() == 4:
        patches = patches[..., 0]
    fits = kernel_ops.pseudo_voigt_fit(patches, n_iter=n_iter,
                                       use_kernel=use_kernel)
    return {
        "centers_px": fits[:, :2],            # (y0, x0)
        "gammas": fits[:, 2:4],
        "amplitudes": fits[:, 4:6],
    }


def label_for_braggnn(patches: torch.Tensor, *,
                      use_kernel: Optional[bool] = None) -> torch.Tensor:
    """BraggNN training targets: fitted centers normalized to [0, 1] by
    the patch side (``centers_px / (ph - 1)``)."""
    p2 = patches[..., 0] if patches.dim() == 4 else patches
    res = analyze_patches(p2, use_kernel=use_kernel)
    return res["centers_px"] / (p2.shape[1] - 1)
