"""Pseudo-Voigt Bragg-peak fit: the wrapper of the port's Hopper kernel.

:func:`pseudo_voigt_fit` (``csrc/pseudo_voigt.cu``) replaces the TPU kernel
``repro/kernels/pseudo_voigt.py::pseudo_voigt_fit``, the paper's "A"
operation: for each (ph, pw) patch, Gauss-Newton fits of a pseudo-Voigt
profile to its row and column marginals.

For a CUDA tensor the wrapper checks its input, allocates the output and
launches the kernel on the current stream, or raises: there is no
fallback.  The kernel masks its own ragged tail, so nothing is padded.
For a CPU tensor it runs the kernel's plain version,
``ref.pseudo_voigt_reference``.  ``launch_counts`` counts kernel launches,
so a run can show that its path went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

PV = "pseudo_voigt"
MAX_N = 32                    # largest patch side the kernel takes

launch_counts: Dict[str, int] = {PV: 0}
_fns: Dict[str, object] = {}


def _kernel():
    """The C launch function of ``csrc/pseudo_voigt.cu``, built and bound
    on first use."""
    if PV not in _fns:
        fn = _build.load(PV).pseudo_voigt_launch
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[PV] = fn
    return _fns[PV]


def reset_launch_counts() -> None:
    """Zero the launch counter of this module."""
    for k in launch_counts:
        launch_counts[k] = 0


def pseudo_voigt_fit(patches: torch.Tensor, *, n_iter: int = 5
                     ) -> torch.Tensor:
    """patches (Np, ph, pw) float32 -> (Np, 6) float32 fits
    (y0, x0, gy, gx, Ay, Ax), for any Np >= 0.  On the card the patches
    must be contiguous and 16-byte aligned, with 1 <= ph, pw <= 32."""
    if not patches.is_cuda:
        return _ref.pseudo_voigt_reference(patches, n_iter)
    if patches.dtype != torch.float32:
        raise TypeError(f"patches must be float32, got {patches.dtype}")
    if patches.dim() != 3:
        raise ValueError(f"patches must be (Np, ph, pw), got "
                         f"{tuple(patches.shape)}")
    if not patches.is_contiguous():
        raise ValueError("patches must be contiguous")
    if patches.data_ptr() % 16:
        raise ValueError("patches must be 16-byte aligned")
    Np, ph, pw = patches.shape
    if not (1 <= ph <= MAX_N and 1 <= pw <= MAX_N):
        raise ValueError(f"patch {ph}x{pw}: the kernel takes sides of 1 to "
                         f"{MAX_N}")
    if n_iter < 0:
        raise ValueError(f"n_iter must be >= 0, got {n_iter}")
    out = torch.empty((Np, 6), dtype=torch.float32, device=patches.device)
    if Np == 0:
        return out
    with torch.cuda.device(patches.device):
        err = _kernel()(patches.data_ptr(), out.data_ptr(), Np, ph, pw,
                        n_iter,
                        torch.cuda.current_stream(patches.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{PV} launch failed: CUDA error {err}")
    launch_counts[PV] += 1
    return out
