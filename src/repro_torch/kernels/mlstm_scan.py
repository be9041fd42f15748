"""Chunkwise stabilized mLSTM: the wrapper of the port's Hopper kernels.

:func:`mlstm_scan` replaces the TPU kernel
``repro/kernels/mlstm_scan.py::mlstm_scan`` (B4): for q/k/v (B, H, L, hd)
and the gates log_i/log_f (B, H, L) float32 it computes xLSTM's mLSTM
output h (B, H, L, hd) in q's dtype, chunk by chunk, with the stabilized
state (C, n, m) carried on chip.  Two kernels, chosen by q's dtype:
bfloat16 runs the tensor-core kernel (``csrc/mlstm_scan_tc.cu``: gates,
mma.sync scores and a wgmma scan fed by TMA), float32 the FMA kernel
(``csrc/mlstm_scan.cu``: scores and scan).  One call launches a kernel's
parts and counts once.

The tensors may be any strided views (the 4-D ones with a contiguous
last axis): ``ops.mlstm_scan_heads`` hands over transposed views of the
model's (B, L, H, hd) layout, read in place.  For CUDA tensors the wrapper checks
its inputs, allocates the output and the kernel's scratch and launches on
the current stream, or raises: there is no fallback, and no backward (the
reference kernel has no VJP either).  For CPU tensors it runs the
kernel's plain version, ``models/xlstm.py::mlstm_chunkwise``.
``launch_counts`` counts kernel launches, so a run can show that its path
went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssm_scan import (check_scan_inputs, rows_aligned,
                                          strides)

MLSTM = "mlstm_scan"           # float32 source in csrc/ and launch counter
MLSTM_TC = "mlstm_scan_tc"     # bfloat16 source in csrc/
MAX_CHUNK = 128
MAX_TC_HD = 1024               # the tensor-core kernel's widest head
_DTYPES = (torch.float32, torch.bfloat16)

launch_counts: Dict[str, int] = {MLSTM: 0}
_fns: Dict[str, object] = {}


def _lib(name: str):
    """The C functions of ``csrc/<name>.cu``, built and bound on first
    use."""
    if name not in _fns:
        lib = _build.load(name)
        # q k v log_i log_f out scratch strides, B H L hd chunk (dtype or
        # vec), scale, stream
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        if name == MLSTM:
            lib.mlstm_scan_smem_bytes.argtypes = [ctypes.c_int] * 2
            lib.mlstm_scan_smem_bytes.restype = ctypes.c_size_t
        else:
            lib.mlstm_scan_tc_workspace_bytes.argtypes = [ctypes.c_int] * 5
            lib.mlstm_scan_tc_workspace_bytes.restype = ctypes.c_size_t
        _fns[name] = lib
    return _fns[name]


def reset_launch_counts() -> None:
    """Zero the launch counter of this module."""
    for k in launch_counts:
        launch_counts[k] = 0


def mlstm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               log_i: torch.Tensor, log_f: torch.Tensor, *,
               chunk: int = 128, out: torch.Tensor = None) -> torch.Tensor:
    """h (B, H, L, hd) of the chunkwise mLSTM (B4), in q's dtype, from the
    zero state.  ``chunk = min(chunk, L)`` must divide L.  On the card:
    float32 or bfloat16 q (k and v of its dtype), chunk <= 128, hd up to
    1024; ``out``, when given, is written (any strided (B, H, L, hd) view
    with a contiguous last axis)."""
    if not q.is_cuda:
        from repro_torch.models.xlstm import mlstm_chunkwise
        h, _ = mlstm_chunkwise(*(t.transpose(1, 2) for t in (q, k, v)),
                               log_i.transpose(1, 2), log_f.transpose(1, 2),
                               chunk)
        return h.transpose(1, 2)
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape or \
            log_i.shape != q.shape[:3] or log_f.shape != q.shape[:3]:
        raise ValueError(f"q/k/v (B, H, L, hd) and log_i/log_f (B, H, L) "
                         f"expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(log_i.shape)}, {tuple(log_f.shape)}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q dtype {q.dtype} not in float32, bfloat16")
    B, H, L, hd = q.shape
    h = torch.empty_like(q) if out is None else out
    if h.shape != q.shape:
        raise ValueError(f"out {tuple(h.shape)} != {tuple(q.shape)}")
    check_scan_inputs((q, k, v, log_i, log_f, h),
                      (q.dtype,) * 3 + (torch.float32,) * 2 + (q.dtype,),
                      ("q", "k", "v", "log_i", "log_f", "out"))
    Q = min(chunk, L)
    if L % Q:
        raise ValueError(f"sequence {L} is not a multiple of chunk {Q}")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), log_i.data_ptr(),
            log_f.data_ptr(), h.data_ptr())
    if q.dtype == torch.bfloat16:
        lib = _lib(MLSTM_TC)
        if Q > MAX_CHUNK or hd > MAX_TC_HD:
            raise ValueError(f"chunk {Q}, hd {hd}: the bf16 kernel takes "
                             f"chunk <= {MAX_CHUNK} and hd <= {MAX_TC_HD}")
        work = torch.empty(lib.mlstm_scan_tc_workspace_bytes(B, H, L, hd, Q),
                           dtype=torch.uint8, device=q.device)
        vec = hd % 8 == 0 and rows_aligned(q, k, v, h)
        with torch.cuda.device(q.device):
            err = lib.mlstm_scan_tc_launch(
                *args, work.data_ptr(), strides(q, k, v, log_i, log_f, h), B,
                H, L, hd, Q, int(vec), 1.0 / hd ** 0.5, stream)
    else:
        lib = _lib(MLSTM)
        if Q > MAX_CHUNK or lib.mlstm_scan_smem_bytes(Q, hd) > 232448:
            raise ValueError(f"chunk {Q}, hd {hd}: the kernel takes chunk "
                             f"<= {MAX_CHUNK} and hd within 227 KB of shared "
                             "memory (hd <= 1024 at chunk 128)")
        scores = torch.empty((B, H, L, Q), dtype=torch.float32,
                             device=q.device)
        with torch.cuda.device(q.device):
            err = lib.mlstm_scan_launch(
                *args, scores.data_ptr(), strides(q, k, v, log_i, log_f, h),
                B, H, L, hd, Q, 0, 1.0 / hd ** 0.5, stream)
    if err != 0:
        raise RuntimeError(f"{MLSTM} launch failed: CUDA error {err}")
    launch_counts[MLSTM] += 1
    return h
