"""Dispatch between the port's kernels and their plain versions.

The counterpart of the paged-tiled half of ``repro/kernels/ops.py``.
With ``use_kernel=None`` the device of ``q`` decides: the CUDA kernel for
CUDA tensors, the plain PyTorch version for CPU tensors.
``use_kernel=False`` pins the plain version on either device (the
comparison path of ``chip_smoke.py``); ``use_kernel=True`` on CPU tensors
raises, since a CUDA kernel cannot run there.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref as _ref


def _resolve(q: torch.Tensor, use_kernel: Optional[bool]) -> bool:
    if use_kernel is None:
        return q.is_cuda
    if use_kernel and not q.is_cuda:
        raise ValueError("use_kernel=True needs CUDA tensors; the kernel "
                         "does not run on the CPU")
    return use_kernel


def paged_attention_ragged_tiled(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor,
                                 block_tables: torch.Tensor,
                                 tile_meta: torch.Tensor,
                                 row_tile: torch.Tensor, *, tile: int,
                                 window: int = 0,
                                 use_kernel: Optional[bool] = None,
                                 k_scale: Optional[torch.Tensor] = None,
                                 v_scale: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """Segment-tiled paged attention read of the flat stream q (T, H, D)
    through the TileMap arrays (``serving.batch.build_tile_map``): per-lane
    ``block_tables``, ``tile_meta`` (5, n_tiles) and ``row_tile`` (T,).
    Returns (T, H, D)."""
    if _resolve(q, use_kernel):
        T, H, D = q.shape
        Hkv = k_pool.shape[2]
        out = _pa.paged_attention_ragged_tiled(
            q.reshape(T, Hkv, H // Hkv, D), k_pool, v_pool, block_tables,
            tile_meta, row_tile, tile=tile, window=window, k_scale=k_scale,
            v_scale=v_scale)
        return out.reshape(T, H, D)
    return _ref.paged_attention_ragged_tiled_reference(
        q, k_pool, v_pool, block_tables, tile_meta, row_tile, tile=tile,
        window=window, k_scale=k_scale, v_scale=v_scale)
