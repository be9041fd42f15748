"""Segment-tiled flat-stream paged attention: the wrapper of the Hopper
kernel ``csrc/paged_attention_tiled.cu``.

It replaces the TPU kernel ``repro/kernels/paged_attention.py::
paged_attention_ragged_tiled``.  For CUDA tensors the wrapper checks its
inputs, allocates the output and launches the kernel on the current
stream, or raises: there is no fallback.  For CPU tensors it runs the
plain version, ``ref.paged_attention_ragged_tiled_reference``.
``launch_counts`` counts kernel launches, so a run can show that its
main path went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

KERNEL = "paged_attention_tiled"
HEAD_DIMS = (64, 128, 256)
SMEM_LIMIT = 232_448          # opt-in dynamic shared memory per block, H100
_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_POOL_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

launch_counts: Dict[str, int] = {KERNEL: 0}
_fn = None
_smem_fn = None


def _kernel():
    """The C entry points, built and bound on first use."""
    global _fn, _smem_fn
    if _fn is None:
        lib = _build.load(KERNEL)
        fn = lib.paged_attention_tiled_launch
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        smem = lib.paged_attention_tiled_smem_bytes
        smem.argtypes = [ctypes.c_int] * 4
        smem.restype = ctypes.c_size_t
        _fn, _smem_fn = fn, smem
    return _fn, _smem_fn


def reset_launch_counts() -> None:
    """Zero every launch counter of this module."""
    for k in launch_counts:
        launch_counts[k] = 0


def _check(name: str, t: torch.Tensor, device: torch.device, dtypes,
           ndim: int) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, q on {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} dtype {t.dtype} not in {sorted(map(str, dtypes))}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def paged_attention_ragged_tiled(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor,
                                 block_tables: torch.Tensor,
                                 tile_meta: torch.Tensor,
                                 row_tile: torch.Tensor, *, tile: int,
                                 window: int = 0,
                                 k_scale: Optional[torch.Tensor] = None,
                                 v_scale: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """q (T, Hkv, G, D) flat token stream; pools (num_blocks, bs, Hkv, D)
    float32, bfloat16 or int8 (with float32 (num_blocks, bs, Hkv)
    ``k_scale``/``v_scale``); ``block_tables`` (n_lanes, max_blocks) int32;
    ``tile_meta`` (5, n_tiles) int32 (``ref.TILE_*`` rows); ``row_tile``
    (T,) owning tile per row (read by the plain version only).  Returns
    (T, Hkv, G, D) in ``q.dtype``.  Rows of the stream that no tile covers
    (stream padding) come back as zeros from the kernel and as finite
    values from the plain version; callers read real rows only."""
    T, Hkv, G, D = q.shape
    if not q.is_cuda:
        out = _ref.paged_attention_ragged_tiled_reference(
            q.reshape(T, Hkv * G, D), k_pool, v_pool, block_tables,
            tile_meta, row_tile, tile=tile, window=window, k_scale=k_scale,
            v_scale=v_scale)
        return out.reshape(T, Hkv, G, D)

    dev = q.device
    _check("q", q, dev, _Q_CODES, 4)
    _check("k_pool", k_pool, dev, _POOL_CODES, 4)
    _check("v_pool", v_pool, dev, (k_pool.dtype,), 4)
    _check("block_tables", block_tables, dev, (torch.int32,), 2)
    _check("tile_meta", tile_meta, dev, (torch.int32,), 2)
    num_blocks, bs, hkv_pool, d_pool = k_pool.shape
    if v_pool.shape != k_pool.shape:
        raise ValueError(f"v_pool {tuple(v_pool.shape)} != k_pool "
                         f"{tuple(k_pool.shape)}")
    if (hkv_pool, d_pool) != (Hkv, D):
        raise ValueError(f"pool heads/dim {(hkv_pool, d_pool)} != q's "
                         f"{(Hkv, D)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not built; the kernel takes "
                         f"{HEAD_DIMS}")
    if bs < 1 or bs & (bs - 1):
        raise ValueError(f"block size {bs} must be a power of two")
    if tile < 1 or tile & (tile - 1):
        raise ValueError(f"tile {tile} must be a power of two")
    if tile_meta.shape[0] != 5:
        raise ValueError(f"tile_meta must be (5, n_tiles), got "
                         f"{tuple(tile_meta.shape)}")
    quantized = k_pool.dtype == torch.int8
    if quantized != (k_scale is not None) or (k_scale is None) != (
            v_scale is None):
        raise ValueError("int8 pools need k_scale and v_scale; other pools "
                         "take neither")
    if quantized:
        for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
            _check(name, sc, dev, (torch.float32,), 3)
            if sc.shape != (num_blocks, bs, Hkv):
                raise ValueError(f"{name} must be {(num_blocks, bs, Hkv)}, "
                                 f"got {tuple(sc.shape)}")
    fn, smem_fn = _kernel()
    smem = smem_fn(tile, G, D, bs)
    if smem > SMEM_LIMIT:
        raise ValueError(f"tile*G*D too large: {smem} bytes of shared "
                         f"memory per block, the card allows {SMEM_LIMIT}")
    out = torch.zeros_like(q)
    n_tiles = tile_meta.shape[1]
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             k_scale.data_ptr() if quantized else None,
             v_scale.data_ptr() if quantized else None,
             block_tables.data_ptr(), tile_meta.data_ptr(), out.data_ptr(),
             _Q_CODES[q.dtype], _POOL_CODES[k_pool.dtype], D, n_tiles, Hkv,
             G, bs, block_tables.shape[1], tile, window,
             1.0 / (D ** 0.5), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed: CUDA error {err}")
    launch_counts[KERNEL] += 1
    return out
