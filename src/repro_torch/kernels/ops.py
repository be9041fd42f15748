"""Dispatch between the port's kernels and their plain versions.

The counterpart of ``repro/kernels/ops.py``: flash attention, paged
attention, the SSD and mLSTM scans and the pseudo-Voigt fit.  With
``use_kernel=None`` the device of the input (``q``, ``x``, ``patches``)
decides: the CUDA kernel for CUDA tensors, the plain PyTorch version for
CPU tensors.
``use_kernel=False`` pins the plain version on either device (the
comparison path of ``chip_smoke.py``); ``use_kernel=True`` on CPU tensors
raises, since a CUDA kernel cannot run there.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mlstm_scan as _ml
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import pseudo_voigt as _pv
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import ssm_scan as _ssd


def resolve_use_kernel(q: torch.Tensor, use_kernel: Optional[bool]) -> bool:
    """Whether a call on ``q`` runs the kernel: ``use_kernel``, or, when
    it is None, whether ``q`` is on the card."""
    if use_kernel is None:
        return q.is_cuda
    if use_kernel and not q.is_cuda:
        raise ValueError("use_kernel=True needs CUDA tensors; the kernel "
                         "does not run on the CPU")
    return use_kernel


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         block_q: int = 128, block_kv: int = 128,
                         use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Model-layout flash attention: q (B, S, H, D), k/v (B, S, Hkv, D) ->
    (B, S, H, D), differentiable.

    The kernel path runs :func:`flash_attention.flash_attention_trainable`
    on transposed views (the kernels read the model layout in place and
    mask their own ragged tail, so nothing is padded or copied).  The
    plain path keeps the reference wrapper's padding of S up to a
    multiple of ``block_q``/``block_kv`` with zero rows around
    ``ref.attention_reference``; the block sizes shape only that padding.
    Under the causal mask real queries never see the padded keys, so the
    padding changes nothing; with ``causal=False`` they see them, as in
    the reference wrapper (the kernel masks them: ROADMAP C).  The
    reference's ``interpret`` flag has no counterpart: ``use_kernel``
    chooses."""
    if resolve_use_kernel(q, use_kernel):
        out = _fa.flash_attention_trainable(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal,
            window)
        return out.transpose(1, 2)
    B, S, H, D = q.shape
    bq = min(block_q, max(16, S))
    bkv = min(block_kv, max(16, S))
    pad = (-S) % max(bq, bkv)
    if pad:
        zk = k.new_zeros((B, pad) + tuple(k.shape[2:]))
        q = torch.cat([q, q.new_zeros((B, pad, H, D))], dim=1)
        k = torch.cat([k, zk], dim=1)
        v = torch.cat([v, zk], dim=1)
    out = _ref.attention_reference(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=causal,
                                   window=window).transpose(1, 2)
    return out[:, :S] if pad else out


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
    if resolve_use_kernel(q, use_kernel):
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


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_tables: torch.Tensor,
                    ctx_lens: torch.Tensor, *, window: int = 0,
                    use_kernel: Optional[bool] = None,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decode-time paged attention read: q (B, 1, H, D) or (B, H, D), one
    token per lane at position ``ctx_lens - 1``, against the pools through
    per-lane ``block_tables``.  Returns q's shape."""
    squeeze = q.dim() == 4
    if squeeze:
        q = q[:, 0]
    if resolve_use_kernel(q, use_kernel):
        B, H, D = q.shape
        Hkv = k_pool.shape[2]
        out = _pa.paged_attention(
            q.reshape(B, Hkv, H // Hkv, D), k_pool, v_pool, block_tables,
            ctx_lens, window=window, k_scale=k_scale,
            v_scale=v_scale).reshape(B, H, D)
    else:
        out = _ref.paged_attention_reference(
            q, k_pool, v_pool, block_tables, ctx_lens, window=window,
            k_scale=k_scale, v_scale=v_scale)
    return out[:, None] if squeeze else out


def paged_attention_chunk(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, block_tables: torch.Tensor,
                          q_starts: torch.Tensor, q_lens: torch.Tensor, *,
                          window: int = 0,
                          use_kernel: Optional[bool] = None,
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Chunked paged attention read: q (B, C, H, D), C query tokens per
    lane from absolute position ``q_starts[b]``, of which ``q_lens[b]``
    are real (padded rows are ignored by callers), causal inside the
    chunk.  Returns (B, C, H, D)."""
    if resolve_use_kernel(q, use_kernel):
        B, C, H, D = q.shape
        Hkv = k_pool.shape[2]
        out = _pa.paged_attention_chunk(
            q.reshape(B, C, Hkv, H // Hkv, D), k_pool, v_pool, block_tables,
            q_starts, q_starts + q_lens, window=window, k_scale=k_scale,
            v_scale=v_scale)
        return out.reshape(B, C, H, D)
    return _ref.paged_attention_chunk_reference(
        q, k_pool, v_pool, block_tables, q_starts, window=window,
        k_scale=k_scale, v_scale=v_scale)


def paged_attention_ragged(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, token_tables: torch.Tensor,
                           token_pos: torch.Tensor, *, window: int = 0,
                           use_kernel: Optional[bool] = None,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Per-token flat-stream paged attention read: q (T, H, D) against the
    pools, ``token_tables`` (T, max_blocks) each token's lane's
    block-table row and ``token_pos`` (T,) its position (the causal
    bound).  Returns (T, H, D)."""
    if resolve_use_kernel(q, use_kernel):
        T, H, D = q.shape
        Hkv = k_pool.shape[2]
        out = _pa.paged_attention_ragged(
            q.reshape(T, Hkv, H // Hkv, D), k_pool, v_pool, token_tables,
            token_pos, window=window, k_scale=k_scale, v_scale=v_scale)
        return out.reshape(T, H, D)
    return _ref.paged_attention_ragged_reference(
        q, k_pool, v_pool, token_tables, token_pos, window=window,
        k_scale=k_scale, v_scale=v_scale)


def pseudo_voigt_fit(patches: torch.Tensor, *, n_iter: int = 5,
                     use_kernel: Optional[bool] = None) -> torch.Tensor:
    """patches (Np, ph, pw) -> (Np, 6) fits (y0, x0, gy, gx, Ay, Ax).  The
    kernel masks its own ragged tail, so unlike the reference's wrapper
    this pads nothing; any Np >= 0 is taken."""
    if resolve_use_kernel(patches, use_kernel):
        return _pv.pseudo_voigt_fit(patches, n_iter=n_iter)
    return _ref.pseudo_voigt_reference(patches, n_iter)


def _refuse_grad(name: str, *ts: torch.Tensor) -> None:
    """The scan kernels have no backward (nor do the reference's): under
    grad mode an input that requires grad raises instead of being
    detached."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(f"{name} kernel has no backward; call it under "
                           "torch.no_grad() or with use_kernel=False")


def ssd_scan_heads(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128,
                   use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Model-layout SSD scan: x (B, L, H, P); dt (B, L, H) float32
    (softplus'd); A (H,) negative; Bm/Cm (B, L, G, N).  Returns y
    (B, L, H, P) in x's dtype.

    The kernel path forms ``xdt = x * dt`` (in x's dtype) and ``dA = dt *
    A`` (float32) as the reference wrapper does and runs
    :func:`ssm_scan.ssd_scan` on transposed views, writing y in the model
    layout.  The plain path is ``models/ssm.py::ssd_chunked``, called as
    ``apply_mamba2`` calls it."""
    if resolve_use_kernel(x, use_kernel):
        _refuse_grad(_ssd.SSD, x, dt, A, Bm, Cm)
        xdt = x * dt[..., None].to(x.dtype)
        dA = dt.to(torch.float32) * A.to(torch.float32)
        y = torch.empty_like(xdt)
        _ssd.ssd_scan(xdt.transpose(1, 2), dA.transpose(1, 2),
                      Bm.transpose(1, 2), Cm.transpose(1, 2), chunk=chunk,
                      out=y.transpose(1, 2))
        return y
    from repro_torch.models.ssm import ssd_chunked
    return ssd_chunked(x, dt, A, Bm, Cm, chunk)[0]


def mlstm_scan_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     log_i: torch.Tensor, log_f: torch.Tensor, *,
                     chunk: int = 128,
                     use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Model-layout chunkwise mLSTM: q/k/v (B, L, H, hd); log_i/log_f
    (B, L, H).  Returns h (B, L, H, hd) in q's dtype.

    The kernel path runs :func:`mlstm_scan.mlstm_scan` on transposed
    views (gates in float32), writing h in the model layout.  The plain
    path is ``models/xlstm.py::mlstm_chunkwise``."""
    if resolve_use_kernel(q, use_kernel):
        _refuse_grad(_ml.MLSTM, q, k, v, log_i, log_f)
        h = torch.empty_like(q)
        _ml.mlstm_scan(q.transpose(1, 2), k.transpose(1, 2),
                       v.transpose(1, 2),
                       log_i.to(torch.float32).transpose(1, 2),
                       log_f.to(torch.float32).transpose(1, 2),
                       chunk=chunk, out=h.transpose(1, 2))
        return h
    from repro_torch.models.xlstm import mlstm_chunkwise
    return mlstm_chunkwise(q, k, v, log_i, log_f, chunk)[0]
