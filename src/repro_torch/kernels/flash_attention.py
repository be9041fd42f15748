"""Flash attention: the wrappers of the port's Hopper kernels for the
forward and the backward, and the differentiable
:func:`flash_attention_trainable`.

Each kernel replaces TPU kernels of ``repro/kernels/flash_attention.py``:

  * :func:`flash_attention` — ``flash_attention`` (B6), the forward;
  * :func:`flash_attention_lse` (the same kernel, with its logsumexp
    output) — ``_flash_fwd_lse`` (B6f), the forward that training saves;
  * :func:`flash_attention_bwd` (two kernels) — ``_flash_bwd``'s
    ``_dq_kernel`` and ``_dkv_kernel`` (B6b).

The input type picks the source: bfloat16, the models' type, runs on the
tensor cores (``csrc/flash_attention_fwd_wgmma.cu``,
``flash_attention_bwd_wgmma.cu``: wgmma fed by TMA); float32 runs float32
FMAs on the CUDA cores (``csrc/flash_attention_fwd.cu``,
``flash_attention_bwd.cu``), which the float32 agreement checks use.
Neither stands in for the other.

All take q (B, H, S, D) and k/v (B, Hkv, S, D) with any strides whose last
one is 1 (transposed views of the model's (B, S, H, D) activations are
read in place), causal with an optional sliding window; any S, since the
kernels mask their ragged tail.  The bfloat16 kernels load their tiles by
TMA, which needs 16-byte aligned tensors and strides: the same layout
check covers both.  For CUDA tensors a wrapper checks its inputs,
allocates the outputs and launches on the current stream of the inputs'
device (made current for the launch, so positions on several cards
each launch on their own), or raises: there is no fallback.  For CPU
tensors it runs the kernel's plain version in ``ref.py``.
``launch_counts`` counts kernel launches by name, so a run can show that
its path went through the kernels.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

FWD = "flash_attention_fwd"          # sources in csrc/: float32
BWD = "flash_attention_bwd"
FWD_TC = "flash_attention_fwd_wgmma"  # bfloat16, tensor cores
BWD_TC = "flash_attention_bwd_wgmma"
B6 = "flash_attention"               # launch counters
B6F = "flash_attention_lse"
B6_DQ = "flash_attention_dq"
B6_DKV = "flash_attention_dkv"
HEAD_DIMS = (64, 80, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launch_counts: Dict[str, int] = {B6: 0, B6F: 0, B6_DQ: 0, B6_DKV: 0}
# the backward launches from one autograd thread a card
_count_lock = threading.Lock()
_fns: Dict[str, object] = {}


def _source(name: str, dtype: torch.dtype) -> str:
    """The csrc/ source of kernel ``name`` for inputs of ``dtype``."""
    tc = dtype == torch.bfloat16
    return ((FWD_TC if tc else FWD) if name == "fwd"
            else (BWD_TC if tc else BWD))


def _kernel(name: str, dtype: torch.dtype):
    """The C launch function of kernel ``name`` ("fwd", "dq" or "dkv")
    for inputs of ``dtype`` (``flash_attention_{name}_launch`` in float32,
    ``flash_attention_{name}_wgmma_launch`` in bfloat16), its source built
    and bound on first use."""
    tc = dtype == torch.bfloat16
    key = f"{name}_wgmma" if tc else name
    if key not in _fns:
        fn = getattr(_build.load(_source(name, dtype)),
                     f"flash_attention_{key}_launch")
        n_ptr = 5 if name == "fwd" else 9
        fn.argtypes = ([ctypes.c_void_p] * (n_ptr + 1) + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return _fns[key]


def reset_launch_counts() -> None:
    """Zero every launch counter of this module."""
    for k in launch_counts:
        launch_counts[k] = 0


def _layout_ok(t: torch.Tensor) -> bool:
    """A contiguous last axis, 16-byte alignment and (b, h, s) strides of
    multiples of 8 elements: what the float32 kernels' vector loads and
    the bfloat16 kernels' TMA (16-byte strides) need."""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % 8 == 0 for s in t.stride()[:3]))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           *others: torch.Tensor) -> None:
    """Shapes, device, type and layout the kernels take."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q (B, H, S, D) and k/v (B, Hkv, S, D) expected, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, S, D = q.shape
    if k.shape[0] != B or k.shape[2:] != (S, D) or H % k.shape[1]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D}: the kernels take {HEAD_DIMS}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q dtype {q.dtype} not in float32, bfloat16")
    for name, t in zip(("q", "k", "v") + ("o/do",) * len(others),
                       (q, k, v) + others):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
        if not _layout_ok(t):
            raise ValueError(f"{name} must have a contiguous last axis, "
                             "16-byte alignment and strides of multiples "
                             "of 8 elements")


def _strides(*ts: torch.Tensor):
    """The (b, h, s) element strides of each tensor, as a C array."""
    vals = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _forward(q, k, v, causal: bool, window: int, with_lse: bool):
    _check(q, k, v)
    B, H, S, D = q.shape
    o = torch.empty_like(q)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if with_lse else None)
    with torch.cuda.device(q.device):
        _raise_on(_kernel("fwd", q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if with_lse else None, _strides(q, k, v, o), B,
            H, k.shape[1], S, D, _DTYPES[q.dtype], int(causal), window,
            1.0 / D ** 0.5, _stream(q)), _source("fwd", q.dtype))
    with _count_lock:
        launch_counts[B6F if with_lse else B6] += 1
    return o, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, H, S, D), k/v (B, Hkv, S, D) -> (B, H, S, D) in q's dtype
    (B6).  On the card: float32 or bfloat16, D in ``HEAD_DIMS``."""
    if not q.is_cuda:
        return _ref.attention_reference(q, k, v, causal=causal,
                                        window=window)
    return _forward(q, k, v, causal, window, False)[0]


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention` and the logsumexp of every query's masked
    scores, (B, H, S) float32 (B6f)."""
    if not q.is_cuda:
        return _ref.attention_lse_reference(q, k, v, causal=causal,
                                            window=window)
    return _forward(q, k, v, causal, window, True)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = True,
                        window: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from the forward's inputs, output ``o`` and logsumexp
    ``lse`` and the output's gradient ``do`` (B6b): ``delta = sum(do *
    o)`` in float32 here, as the reference forms it outside its kernels,
    then the dq kernel and the dk/dv kernel."""
    if not q.is_cuda:
        return _ref.attention_bwd_reference(q, k, v, o, lse, do,
                                            causal=causal, window=window)
    _check(q, k, v, o, do)
    B, H, S, D = q.shape
    if lse.shape != (B, H, S) or lse.dtype != torch.float32 or (
            not lse.is_contiguous()) or lse.device != q.device:
        raise ValueError("lse must be a contiguous (B, H, S) float32 tensor "
                         "on q's device")
    delta = (do.to(torch.float32) * o.to(torch.float32)).sum(
        dim=-1).contiguous()
    grads = tuple(torch.empty_like(t) for t in (q, k, v))
    for which in ("dq", "dkv"):
        launch_bwd_kernel(which, q, k, v, do, lse, delta, *grads,
                          causal=causal, window=window)
    return grads


def launch_bwd_kernel(which: str, q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                      delta: torch.Tensor, dq: torch.Tensor, dk: torch.Tensor,
                      dv: torch.Tensor, *, causal: bool, window: int) -> None:
    """Launch one of B6b's two kernels, ``which`` = "dq" (writes dq) or
    "dkv" (writes dk and dv), on inputs :func:`flash_attention_bwd` has
    checked and outputs it has allocated (``delta`` contiguous (B, H, S)
    float32); it runs both, and a timing can run one alone."""
    B, H, S, D = q.shape
    with torch.cuda.device(q.device):
        _raise_on(_kernel(which, q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), _strides(q, k, v, do, dq, dk, dv), B, H,
            k.shape[1], S, D, _DTYPES[q.dtype], int(causal), window,
            1.0 / D ** 0.5, _stream(q)), f"{_source(which, q.dtype)} {which}")
    with _count_lock:
        launch_counts[B6_DQ if which == "dq" else B6_DKV] += 1


class _FlashAttention(torch.autograd.Function):
    """The reference's ``custom_vjp``: the forward saves q, k, v, o and
    the logsumexp; the backward runs :func:`flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o, lse = flash_attention_lse(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.is_cuda and not _layout_ok(do):
            do = do.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do,
                                         causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention_trainable(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True,
                              window: int = 0) -> torch.Tensor:
    """Differentiable flash attention, kernels forward and backward: when
    autograd records (grad mode on and an input requiring grad) the
    forward is B6f and the backward B6b; otherwise the forward is B6, the
    primal of the reference's ``flash_attention_trainable``."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window)
    return flash_attention(q, k, v, causal=causal, window=window)
