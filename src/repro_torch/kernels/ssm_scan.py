"""Mamba2 SSD chunked scan: the wrapper of the port's Hopper kernel.

:func:`ssd_scan` replaces the TPU kernel
``repro/kernels/ssm_scan.py::ssd_scan`` (B5): for xdt (B, H, L, P), dA
(B, H, L) float32 and the maps Bm/Cm (B, G, L, N) it computes the SSD
scan's output y (B, H, L, P) in xdt's dtype, chunk by chunk, with the
(P x N) state carried on chip.  Two kernels, chosen by xdt's dtype:
bfloat16 runs the tensor-core kernel (``csrc/ssm_scan_tc.cu``: mma.sync
products, the state in registers, a cp.async ring), float32 the FMA
kernel (``csrc/ssm_scan.cu``).

The tensors may be any strided views (the 4-D ones with a contiguous
last axis): ``ops.ssd_scan_heads`` hands over transposed views of the
model's (B, L, H, P) layout, read in place; the bf16 kernel copies rows
16 bytes at a time, so every row of its bf16 tensors must start on 16
bytes.  For CUDA tensors the wrapper checks its inputs, allocates the
output and launches on the current stream, or raises: there is no
fallback (a misaligned bf16 view raises too), and no backward (the
reference kernel has no VJP either).  For CPU tensors it runs ``ref.ssd_reference``, the
sequential recurrence.  ``launch_counts`` counts kernel launches, so a
run can show that its path went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

SRC = "ssm_scan"               # float32 source in csrc/
SRC_TC = "ssm_scan_tc"         # bfloat16 source in csrc/
SSD = "ssd_scan"               # launch counter
MAX_CHUNK = 128
MAX_WIDTH = 128                # largest P and N

launch_counts: Dict[str, int] = {SSD: 0}
_fns: Dict[str, object] = {}


def _lib(name: str):
    """The C functions of ``csrc/<name>.cu``, built and bound on first
    use."""
    if name not in _fns:
        lib = _build.load(name)
        # xdt dA Bm Cm y strides, B H G L P N chunk (dtype), stream
        fn = getattr(lib, f"{name}_launch")
        n_int = 8 if name == SRC else 7
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        if name == SRC:
            lib.ssm_scan_smem_bytes.argtypes = [ctypes.c_int] * 3
            lib.ssm_scan_smem_bytes.restype = ctypes.c_size_t
        _fns[name] = lib
    return _fns[name]


def rows_aligned(*ts: torch.Tensor) -> bool:
    """Whether every row of these (B, heads, L, width) bf16 views starts
    on 16 bytes (base and the strides of axes longer than 1 multiples of
    8 elements), so a tensor-core scan copies them 16 bytes at a time."""
    return all(t.data_ptr() % 16 == 0 and all(
        st % 8 == 0 for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1)
        for t in ts)


def reset_launch_counts() -> None:
    """Zero the launch counter of this module."""
    for k in launch_counts:
        launch_counts[k] = 0


def check_scan_inputs(tensors, dtypes, names) -> None:
    """Device, dtype and layout checks shared by the scan wrappers: each
    tensor on the first one's device, of its listed dtype; a 4-D tensor
    with a contiguous last axis (a 3-D one, read one value a position,
    may have any strides)."""
    dev = tensors[0].device
    for name, t, dt in zip(names, tensors, dtypes):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, not {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name} dtype {t.dtype}, expected {dt}")
        if t.dim() == 4 and t.stride(-1) != 1:
            raise ValueError(f"{name} must have a contiguous last axis")


def strides(*ts: torch.Tensor):
    """The (b, head, l) element strides of each tensor, as a C array (0
    for an axis of length 1, which is never stepped)."""
    vals = [st if n > 1 else 0 for t in ts
            for st, n in zip(t.stride()[:3], t.shape[:3])]
    return (ctypes.c_longlong * len(vals))(*vals)


def ssd_scan(xdt: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, *, chunk: int = 128,
             out: torch.Tensor = None) -> torch.Tensor:
    """y (B, H, L, P) of the SSD scan (B5), in xdt's dtype.

    xdt: (B, H, L, P) inputs multiplied by dt; dA: (B, H, L) float32, dt
    times A (negative); Bm/Cm: (B, G, L, N).  ``chunk = min(chunk, L)``
    must divide L.  On the card: float32 or bfloat16 xdt (Bm and Cm of
    its dtype), chunk <= 128, P and N <= 128; ``out``, when given, is
    written (any strided (B, H, L, P) view with a contiguous last axis).
    bfloat16 xdt, Bm, Cm and ``out`` must have every row on 16 bytes."""
    if not xdt.is_cuda:
        return _ref.ssd_reference(xdt, dA, Bm, Cm)
    if xdt.dim() != 4 or dA.dim() != 3 or Bm.dim() != 4 or \
            Bm.shape != Cm.shape:
        raise ValueError(f"xdt (B, H, L, P), dA (B, H, L) and Bm/Cm "
                         f"(B, G, L, N) expected, got {tuple(xdt.shape)}, "
                         f"{tuple(dA.shape)}, {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)}")
    B, H, L, P = xdt.shape
    G, N = Bm.shape[1], Bm.shape[3]
    if dA.shape != (B, H, L) or Bm.shape[0] != B or Bm.shape[2] != L or \
            H % G:
        raise ValueError(f"dA {tuple(dA.shape)} or Bm {tuple(Bm.shape)} "
                         f"do not fit xdt {tuple(xdt.shape)}")
    if xdt.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"xdt dtype {xdt.dtype} not in float32, bfloat16")
    y = torch.empty_like(xdt) if out is None else out
    check_scan_inputs((xdt, dA, Bm, Cm, y), (xdt.dtype, torch.float32,
                                             xdt.dtype, xdt.dtype,
                                             xdt.dtype),
                      ("xdt", "dA", "Bm", "Cm", "out"))
    if y.shape != xdt.shape:
        raise ValueError(f"out {tuple(y.shape)} != {tuple(xdt.shape)}")
    Q = min(chunk, L)
    if L % Q:
        raise ValueError(f"sequence {L} is not a multiple of chunk {Q}")
    if Q > MAX_CHUNK or P > MAX_WIDTH or N > MAX_WIDTH:
        raise ValueError(f"chunk {Q}, P {P}, N {N}: the kernel takes chunk "
                         f"<= {MAX_CHUNK}, P, N <= {MAX_WIDTH}")
    tc = xdt.dtype == torch.bfloat16
    if tc and not rows_aligned(xdt, Bm, Cm, y):
        raise ValueError("bf16 xdt, Bm, Cm and out must have every row on "
                         "16 bytes (16-byte aligned base, strides multiples "
                         "of 8)")
    name = SRC_TC if tc else SRC
    lib = _lib(name)
    args = (xdt.data_ptr(), dA.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            y.data_ptr(), strides(xdt, dA, Bm, Cm, y), B, H, G, L, P, N, Q)
    stream = torch.cuda.current_stream(xdt.device).cuda_stream
    if not tc and lib.ssm_scan_smem_bytes(Q, P, N) > 232448:
        raise ValueError(f"chunk {Q}, P {P}, N {N}: the float32 kernel "
                         "takes them within 227 KB of shared memory")
    with torch.cuda.device(xdt.device):
        err = (lib.ssm_scan_tc_launch(*args, stream) if tc
               else lib.ssm_scan_launch(*args, 0, stream))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    launch_counts[SSD] += 1
    return y
