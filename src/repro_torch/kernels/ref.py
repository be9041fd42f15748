"""Plain PyTorch versions of the port's kernels.

Each function is the mathematical specification its CUDA kernel must
match; the port's tests hold it to the reference package's own oracle
(``repro/kernels/ref.py``) on the same inputs, and ``chip_smoke.py`` holds
the kernel to it on the card.  It is also the serving path for CPU
tensors (``kernels/ops.py`` dispatches here by device).

Dtype choices copy the reference: scores are contracted in the input
dtype and then cast to float32, and the softmax weights are cast back to
``q.dtype`` before the PV contraction.  Where the reference lets jnp
promote mixed dtypes (an int8 pool dequantized to float32 against a bf16
query), the port promotes explicitly, since torch contractions refuse
mixed operands; the result is returned in ``q.dtype``, as the kernel
writes it.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30

# rows of the (5, n_tiles) int32 tile metadata shared by the kernel, this
# oracle and serving.batch.TileMap
TILE_WINDOW, TILE_LO, TILE_HI, TILE_POS0, TILE_LANE = range(5)


def _apply_block_scales(spans: torch.Tensor, scale_pool: torch.Tensor,
                        tables: torch.Tensor) -> torch.Tensor:
    """Dequantize gathered int8 KV spans (rows, S, Hkv, D) with the scale
    spans gathered through the same block tables."""
    rows = tables.shape[0]
    sc = scale_pool[tables].reshape(rows, -1, scale_pool.shape[2])
    return spans.to(torch.float32) * sc[..., None]


def _gather_block_spans(pool: torch.Tensor,
                        tables: torch.Tensor) -> torch.Tensor:
    """Row r of the result is the gathered span ``pool[tables[r]]``
    flattened to (rows, max_blocks * bs, Hkv, D)."""
    rows, max_blocks = tables.shape
    _, bs, Hkv, D = pool.shape
    return pool[tables].reshape(rows, max_blocks * bs, Hkv, D)


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with jnp's type promotion for mixed operands."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def _masked_attention(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      valid: torch.Tensor, eq_s: str, eq_o: str
                      ) -> torch.Tensor:
    """Scores of ``qg`` against gathered spans ``k`` by ``eq_s`` in the
    input dtype, cast to float32 and scaled, masked to -1e30 outside
    ``valid`` (broadcast against the scores), softmax, weights cast back
    to ``qg.dtype``, then ``eq_o`` against ``v`` -- the reference's
    dtype choices."""
    s = _einsum(eq_s, qg, k).to(torch.float32) / (qg.shape[-1] ** 0.5)
    s = torch.where(valid, s, torch.tensor(NEG_INF, dtype=s.dtype,
                                           device=s.device))
    w = torch.softmax(s, dim=-1).to(qg.dtype)
    return _einsum(eq_o, w, v)


def paged_attention_chunk_reference(
        q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
        block_tables: torch.Tensor, q_starts: torch.Tensor, *,
        window: int = 0, k_scale: Optional[torch.Tensor] = None,
        v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, C, H, D), a chunk of C query tokens per lane, token c at
    absolute position ``q_starts[b] + c``; ``block_tables`` (B,
    max_blocks).  Returns (B, C, H, D) in ``q.dtype``.

    Logical kv position t of lane b lives in block ``block_tables[b, t //
    bs]`` at offset ``t % bs``; query c masks kv positions past
    ``q_starts[b] + c`` (and outside the sliding window), so causality
    holds inside the chunk.  Padded queries give finite values that
    callers ignore."""
    B, C, H, D = q.shape
    Hkv = k_pool.shape[2]
    tables = block_tables.long()
    k = _gather_block_spans(k_pool, tables)           # (B, S, Hkv, D)
    v = _gather_block_spans(v_pool, tables)
    if k_scale is not None:
        k = _apply_block_scales(k, k_scale, tables)
        v = _apply_block_scales(v, v_scale, tables)
    qpos = q_starts.long()[:, None] + torch.arange(C, device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)[None, None, :]
    valid = kpos <= qpos[:, :, None]                   # (B, C, S)
    if window:
        valid &= (qpos[:, :, None] - kpos) < window
    out = _masked_attention(q.reshape(B, C, Hkv, H // Hkv, D), k, v,
                            valid[:, :, None, None, :],
                            "bckgd,bskd->bckgs", "bckgs,bskd->bckgd")
    return out.reshape(B, C, H, D).to(q.dtype)


def paged_attention_reference(
        q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
        block_tables: torch.Tensor, ctx_lens: torch.Tensor, *,
        window: int = 0, k_scale: Optional[torch.Tensor] = None,
        v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, H, D), one query token per lane at position ``ctx_lens - 1``:
    the decode case of :func:`paged_attention_chunk_reference`.  Returns
    (B, H, D) in ``q.dtype``."""
    return paged_attention_chunk_reference(
        q[:, None], k_pool, v_pool, block_tables, ctx_lens - 1,
        window=window, k_scale=k_scale, v_scale=v_scale)[:, 0]


def paged_attention_ragged_reference(
        q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
        token_tables: torch.Tensor, token_pos: torch.Tensor, *,
        window: int = 0, k_scale: Optional[torch.Tensor] = None,
        v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (T, H, D), one flat stream of query tokens from many lanes;
    ``token_tables`` (T, max_blocks), row t the block-table row of token
    t's lane; ``token_pos`` (T,) its absolute position.  Returns (T, H, D)
    in ``q.dtype``.

    Token t attends to kv positions ``<= token_pos[t]`` of its own lane's
    blocks (and inside the sliding window), one span gather per token.
    Padding tokens (zero tables, position 0) give finite values that
    callers ignore."""
    T, H, D = q.shape
    Hkv = k_pool.shape[2]
    tables = token_tables.long()
    k = _gather_block_spans(k_pool, tables)           # (T, S, Hkv, D)
    v = _gather_block_spans(v_pool, tables)
    if k_scale is not None:
        k = _apply_block_scales(k, k_scale, tables)
        v = _apply_block_scales(v, v_scale, tables)
    pos = token_pos.long()[:, None]
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]
    valid = kpos <= pos                                # (T, S)
    if window:
        valid &= (pos - kpos) < window
    out = _masked_attention(q.reshape(T, Hkv, H // Hkv, D), k, v,
                            valid[:, None, None, :],
                            "tkgd,tskd->tkgs", "tkgs,tskd->tkgd")
    return out.reshape(T, H, D).to(q.dtype)


def paged_attention_ragged_tiled_reference(
        q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
        tables: torch.Tensor, tile_meta: torch.Tensor,
        row_tile: torch.Tensor, *, tile: int, window: int = 0,
        k_scale: Optional[torch.Tensor] = None,
        v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (T, H, D) flat token stream attended through the segment-tiled
    metadata: ``tables`` (n_lanes, max_blocks) per-lane block rows,
    ``tile_meta`` (5, n_tiles) int32 (``TILE_*`` rows), ``row_tile`` (T,)
    the owning tile of every flat row.  Returns (T, H, D) in ``q.dtype``.

    Each lane's KV span is gathered once; tile t attends its q rows
    ``[lo, hi)`` against its lane's span with the causal bound
    ``pos0 + (row - lo)`` (and the sliding window).  Rows outside the
    tile's span are masked; inert tiles (lo == hi) and stream-padding rows
    give finite values that callers ignore.
    """
    T, H, D = q.shape
    _, bs, Hkv, _ = k_pool.shape
    G = H // Hkv
    tables = tables.long()
    meta = tile_meta.long()
    S = tables.shape[1] * bs
    n_windows = -(-T // tile)
    pad = n_windows * tile - T
    qw = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad))
    qw = qw.reshape(n_windows, tile, Hkv, G, D)
    k_lanes = _gather_block_spans(k_pool, tables)      # (n_lanes, S, Hkv, D)
    v_lanes = _gather_block_spans(v_pool, tables)
    if k_scale is not None:
        k_lanes = _apply_block_scales(k_lanes, k_scale, tables)
        v_lanes = _apply_block_scales(v_lanes, v_scale, tables)
    win, lo, hi = meta[TILE_WINDOW], meta[TILE_LO], meta[TILE_HI]
    pos0, lane = meta[TILE_POS0], meta[TILE_LANE]
    qt = qw[win]                                   # (n_tiles, tile, Hkv, G, D)
    kt = k_lanes[lane]                             # (n_tiles, S, Hkv, D)
    vt = v_lanes[lane]
    dev = q.device
    rows = win[:, None] * tile + torch.arange(tile, device=dev)[None, :]
    qpos = pos0[:, None] + rows - lo[:, None]
    rowvalid = (rows >= lo[:, None]) & (rows < hi[:, None])
    kpos = torch.arange(S, device=dev)[None, None, :]
    valid = rowvalid[:, :, None] & (kpos <= qpos[:, :, None])
    if window:
        valid &= (qpos[:, :, None] - kpos) < window
    ot = _masked_attention(qt, kt, vt, valid[:, :, None, None, :],
                           "ntkgd,nskd->ntkgs",
                           "ntkgs,nskd->ntkgd")   # (n_tiles, tile, Hkv, G, D)
    r = torch.arange(T, device=dev)
    t_idx = row_tile[:T].long()
    off = torch.clamp(r - win[t_idx] * tile, 0, tile - 1)
    return ot[t_idx, off].reshape(T, H, D).to(q.dtype)
