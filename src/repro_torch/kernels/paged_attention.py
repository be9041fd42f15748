"""Paged attention: the wrappers of the port's three Hopper reads.

Each replaces one TPU kernel of ``repro/kernels/paged_attention.py``:

  * :func:`paged_attention_ragged_tiled` — ``paged_attention_ragged_tiled``,
    the segment-tiled flat-stream read of the default paged step;
  * :func:`paged_attention_ragged` — ``paged_attention_ragged``, the
    per-token flat-stream read of the ``tiled=False`` step;
  * :func:`paged_attention_chunk` and :func:`paged_attention` —
    ``_paged_attention_rows`` behind ``paged_attention_chunk`` and
    ``paged_attention``, the rectangular read of the ``ragged=False`` step
    (C = 1 is decode).

Each read has two kernels, as the flash kernels do: bf16 q with bf16 or
int8 pools (the serving path's types) runs the tensor-core split sweep
(``csrc/paged_attention_tiled_tc.cu``, ``csrc/paged_attention_ragged_tc.cu``,
``csrc/paged_attention_rows_tc.cu`` on ``paged_attention_split.cuh``),
float32 q or pools the FMA kernels (``csrc/paged_attention_tiled.cu``,
``csrc/paged_attention_ragged.cu``, ``csrc/paged_attention_rows.cu``).
The split sweep cuts each key range into splits of whole blocks when its
CTAs would not fill two waves of the card (:func:`split_plan`,
:func:`item_splits`) and merges them with a second kernel of the same
library; a read counts as one launch all the same.

For CUDA tensors a wrapper checks its inputs, allocates the output (and
the split scratch) and launches its kernel on the current stream, or
raises: there is no fallback.  For CPU tensors it runs the kernel's plain
version in ``ref.py``.  ``launch_counts`` counts kernel launches by read
(``TILED``, ``RAGGED``, ``ROWS``), so a run can show that its path went
through the kernel; a lock guards each count, because the data-parallel
front steps its slices from several threads.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

TILED = "paged_attention_tiled"
RAGGED = "paged_attention_ragged"
ROWS = "paged_attention_rows"
TILED_TC = "paged_attention_tiled_tc"
RAGGED_TC = "paged_attention_ragged_tc"
ROWS_TC = "paged_attention_rows_tc"
HEAD_DIMS = (64, 128, 256)
SMEM_LIMIT = 232_448          # opt-in dynamic shared memory per block, H100
ROW_GROUP = 32                # q rows per thread block of the rows kernel
TC_ROWS = 16                  # q rows per CTA of the split sweep (m16)
SPLIT_KEYS = 256              # keys a split sweeps when ranges are cut
FILL_CTAS = 264               # two waves of CTAs on the H100's 132 SMs
_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_POOL_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# pointer and int arguments of each C launch function, before the float
# scale and the stream
_ARITY = {TILED: (8, 10), RAGGED: (8, 9), ROWS: (9, 11),
          TILED_TC: (10, 11), RAGGED_TC: (10, 10), ROWS_TC: (11, 11)}

launch_counts: Dict[str, int] = {name: 0 for name in (TILED, RAGGED, ROWS)}
_count_lock = threading.Lock()
_fns: Dict[str, tuple] = {}


def _kernel(name: str):
    """(launch, smem_bytes): the C entry points of ``csrc/<name>.cu``,
    built and bound on first use (the split sweeps' shared memory is
    fixed at compile time: they have no smem_bytes)."""
    if name not in _fns:
        lib = _build.load(name)
        n_ptr, n_int = _ARITY[name]
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        smem = None
        if name not in (TILED_TC, RAGGED_TC, ROWS_TC):
            smem = getattr(lib, f"{name}_smem_bytes")
            smem.argtypes = [ctypes.c_int] * 3
            smem.restype = ctypes.c_size_t
        _fns[name] = (fn, smem)
    return _fns[name]


def split_plan(n_ctas: int, span_blocks: int, bs: int) -> Tuple[int, int]:
    """(split_blocks, n_splits) of a split-sweep launch of ``n_ctas``
    (item, kv head) CTAs whose key ranges cover at most ``span_blocks``
    blocks of ``bs`` keys.  CTAs that fill two waves of the card sweep
    their whole range (one split; ``span_blocks + 1`` is past any range);
    fewer cut it into runs of ``SPLIT_KEYS`` keys of whole blocks, and
    ``n_splits`` is the most any range needs."""
    if n_ctas >= FILL_CTAS:
        return span_blocks + 1, 1
    sb = max(1, SPLIT_KEYS // bs)
    return sb, max(1, -(-span_blocks // sb))


def item_splits(lo: int, hi: int, bs: int, split_blocks: int
                ) -> List[Tuple[int, int]]:
    """The key ranges [k_lo, k_hi] of the splits of one item's needed keys
    [lo, hi], in the kernels' order (``num_splits``/``split_keys`` of
    ``paged_attention_split.cuh``): its blocks ``lo // bs .. hi // bs``
    (none wholly before a window's start) in runs of ``split_blocks``.
    An empty range (``hi < lo``) is one empty split."""
    if hi < lo:
        return [(lo, hi)]
    first, last = lo // bs, hi // bs
    return [(max(lo, j * bs), min(hi, (j + split_blocks) * bs - 1))
            for j in range(first, last + 1, split_blocks)]


def needed_keys(minpos: int, maxpos: int, window: int, max_blocks: int,
                bs: int) -> Tuple[int, int]:
    """[lo, hi]: the keys rows at positions ``minpos .. maxpos`` need (the
    causal bound, the window, the end of the block table)."""
    lo = max(0, minpos - window + 1) if window > 0 else 0
    return lo, min(maxpos, max_blocks * bs - 1)


def span_blocks(max_blocks: int, bs: int, window: int, tokens: int) -> int:
    """The most blocks one item's needed keys can touch: the whole table,
    or with a window the window and the item's other ``tokens - 1``
    positions, one block more for a range that starts inside a block."""
    if window <= 0:
        return max_blocks
    return min(max_blocks, -(-(window + tokens - 1) // bs) + 1)


def _tensor_cores(q: torch.Tensor, k_pool: torch.Tensor) -> bool:
    """Whether the read takes the tensor-core split sweep: bf16 q with
    bf16 or int8 pools."""
    return q.dtype == torch.bfloat16 and k_pool.dtype in (torch.bfloat16,
                                                          torch.int8)


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


def _check_pools(q: torch.Tensor, k_pool: torch.Tensor,
                 v_pool: torch.Tensor, k_scale: Optional[torch.Tensor],
                 v_scale: Optional[torch.Tensor]) -> None:
    """The checks every kernel makes of q (..., Hkv, G, D), the pools and
    the int8 scales."""
    dev = q.device
    _check("q", q, dev, _Q_CODES, q.dim())
    _check("k_pool", k_pool, dev, _POOL_CODES, 4)
    _check("v_pool", v_pool, dev, (k_pool.dtype,), 4)
    num_blocks, bs, hkv_pool, d_pool = k_pool.shape
    Hkv, D = q.shape[-3], q.shape[-1]
    if v_pool.shape != k_pool.shape:
        raise ValueError(f"v_pool {tuple(v_pool.shape)} != k_pool "
                         f"{tuple(k_pool.shape)}")
    if (hkv_pool, d_pool) != (Hkv, D):
        raise ValueError(f"pool heads/dim {(hkv_pool, d_pool)} != q's "
                         f"{(Hkv, D)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not built; the kernels take "
                         f"{HEAD_DIMS}")
    if bs < 1 or bs & (bs - 1):
        raise ValueError(f"block size {bs} must be a power of two")
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


def _launch(name: str, rows: int, q: torch.Tensor, k_pool: torch.Tensor,
            v_pool: torch.Tensor, k_scale: Optional[torch.Tensor],
            v_scale: Optional[torch.Tensor], ptrs, ints, out: torch.Tensor
            ) -> torch.Tensor:
    """Launch kernel ``name`` whose blocks hold ``rows`` q rows: the
    pointers are q, the pools, the scales, ``ptrs`` (metadata) and out;
    the ints are the dtype codes, D and ``ints``."""
    fn, smem_fn = _kernel(name)
    D, bs = q.shape[-1], k_pool.shape[1]
    smem = smem_fn(rows, D, bs)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{rows} q rows of head dim {D} need {smem} bytes "
                         f"of shared memory per block, the card allows "
                         f"{SMEM_LIMIT}")
    quantized = k_scale is not None
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 k_scale.data_ptr() if quantized else None,
                 v_scale.data_ptr() if quantized else None,
                 *(p.data_ptr() for p in ptrs), out.data_ptr(),
                 _Q_CODES[q.dtype], _POOL_CODES[k_pool.dtype], D, *ints,
                 1.0 / (D ** 0.5),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    with _count_lock:
        launch_counts[name] += 1
    return out


def _launch_split(name: str, count_as: str, q: torch.Tensor,
                  k_pool: torch.Tensor, v_pool: torch.Tensor,
                  k_scale: Optional[torch.Tensor],
                  v_scale: Optional[torch.Tensor], ptrs, n_items: int,
                  rows: int, span: int, ints, max_blocks: int, window: int,
                  out: torch.Tensor, live_items: Optional[int] = None
                  ) -> torch.Tensor:
    """Launch the split sweep ``name`` over ``n_items`` items of at most
    ``rows`` q rows whose ranges touch at most ``span`` blocks: the
    pointers are q, the pools, the scales, ``ptrs`` (metadata; None
    passes a null pointer), out and the split scratch; the ints the pool
    dtype code, D, ``ints``, bs, ``max_blocks``, ``window`` and the split
    plan, decided from ``live_items`` (default ``n_items``), the most
    items that can have rows.  Counts one launch of ``count_as``."""
    fn, _ = _kernel(name)
    D, Hkv, bs = q.shape[-1], k_pool.shape[2], k_pool.shape[1]
    split_blocks, n_splits = split_plan(
        (n_items if live_items is None else live_items) * Hkv, span, bs)
    acc = ml = None
    if n_splits > 1:
        acc = torch.empty((n_splits, n_items, Hkv, rows, D),
                          dtype=torch.float32, device=q.device)
        ml = torch.empty((n_splits, n_items, Hkv, rows, 2),
                         dtype=torch.float32, device=q.device)
    quantized = k_scale is not None
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 k_scale.data_ptr() if quantized else None,
                 v_scale.data_ptr() if quantized else None,
                 *(None if p is None else p.data_ptr() for p in ptrs),
                 out.data_ptr(), acc.data_ptr() if acc is not None else None,
                 ml.data_ptr() if ml is not None else None,
                 _POOL_CODES[k_pool.dtype], D, *ints, bs, max_blocks, window,
                 split_blocks, n_splits, 1.0 / (D ** 0.5),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    with _count_lock:
        launch_counts[count_as] += 1
    return out


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
    _check_pools(q, k_pool, v_pool, k_scale, v_scale)
    _check("block_tables", block_tables, q.device, (torch.int32,), 2)
    _check("tile_meta", tile_meta, q.device, (torch.int32,), 2)
    if tile < 1 or tile & (tile - 1):
        raise ValueError(f"tile {tile} must be a power of two")
    if tile_meta.shape[0] != 5:
        raise ValueError(f"tile_meta must be (5, n_tiles), got "
                         f"{tuple(tile_meta.shape)}")
    n_tiles = tile_meta.shape[1]
    if _tensor_cores(q, k_pool):
        # of the n_windows + n_lanes capacity tiles at most T have rows
        # (each owns one row or more): the plan counts those, from shapes
        groups = -(-tile * G // TC_ROWS)
        max_blocks = block_tables.shape[1]
        tokens = min(tile, (TC_ROWS - 1) // G + 2)   # an item's positions
        return _launch_split(
            TILED_TC, TILED, q, k_pool, v_pool, k_scale, v_scale,
            (block_tables, tile_meta), n_tiles * groups,
            min(tile * G, TC_ROWS),
            span_blocks(max_blocks, k_pool.shape[1], window, tokens),
            (n_tiles, Hkv, G, tile), max_blocks, window,
            torch.zeros_like(q), live_items=min(n_tiles, T) * groups)
    return _launch(TILED, tile * G, q, k_pool, v_pool, k_scale, v_scale,
                   (block_tables, tile_meta), (
                       n_tiles, Hkv, G, k_pool.shape[1],
                       block_tables.shape[1], tile, window),
                   torch.zeros_like(q))


def paged_attention_ragged(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, token_tables: torch.Tensor,
                           token_pos: torch.Tensor, *, window: int = 0,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """q (T, Hkv, G, D) flat token stream; pools and scales as in
    :func:`paged_attention_ragged_tiled`; ``token_tables`` (T, max_blocks)
    int32, row t the block-table row of token t's lane; ``token_pos`` (T,)
    int32 its absolute position.  Returns (T, Hkv, G, D) in ``q.dtype``;
    padding tokens (zero table row, position 0) give finite values."""
    T, Hkv, G, D = q.shape
    if not q.is_cuda:
        out = _ref.paged_attention_ragged_reference(
            q.reshape(T, Hkv * G, D), k_pool, v_pool, token_tables,
            token_pos, window=window, k_scale=k_scale, v_scale=v_scale)
        return out.reshape(T, Hkv, G, D)
    _check_pools(q, k_pool, v_pool, k_scale, v_scale)
    _check("token_tables", token_tables, q.device, (torch.int32,), 2)
    _check("token_pos", token_pos, q.device, (torch.int32,), 1)
    if token_tables.shape[0] != T or token_pos.shape[0] != T:
        raise ValueError(f"token_tables {tuple(token_tables.shape)} and "
                         f"token_pos {tuple(token_pos.shape)} must have "
                         f"T = {T} rows")
    if _tensor_cores(q, k_pool):
        groups = -(-G // TC_ROWS)
        max_blocks = token_tables.shape[1]
        return _launch_split(
            RAGGED_TC, RAGGED, q, k_pool, v_pool, k_scale, v_scale,
            (token_tables, token_pos), T * groups, min(G, TC_ROWS),
            span_blocks(max_blocks, k_pool.shape[1], window, 1),
            (T, Hkv, G), max_blocks, window, torch.empty_like(q))
    return _launch(RAGGED, G, q, k_pool, v_pool, k_scale, v_scale,
                   (token_tables, token_pos), (
                       T, Hkv, G, k_pool.shape[1], token_tables.shape[1],
                       window),
                   torch.empty_like(q))


def paged_attention_chunk(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, block_tables: torch.Tensor,
                          q_starts: torch.Tensor, ctx_lens: torch.Tensor, *,
                          window: int = 0,
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Chunked prefill/decode: q (B, C, Hkv, G, D), C query tokens per
    lane (the model's (B, C, H, D) layout, viewed), token c at absolute
    position ``q_starts[b] + c``; ``block_tables`` (B, max_blocks) int32;
    ``ctx_lens`` (B,) int32, each lane's valid KV length after the chunk
    (``q_starts + q_lens``).  Returns (B, C, Hkv, G, D) in ``q.dtype``.
    Chunk rows at or past ``ctx_lens`` are padding: the kernels write them
    as zeros, the plain version computes finite values; callers ignore
    them."""
    B, C, Hkv, G, D = q.shape
    if not q.is_cuda:
        out = _ref.paged_attention_chunk_reference(
            q.reshape(B, C, Hkv * G, D), k_pool, v_pool, block_tables,
            q_starts, window=window, k_scale=k_scale, v_scale=v_scale)
        return out.reshape(B, C, Hkv, G, D)
    return _rows(q, k_pool, v_pool, block_tables, q_starts, ctx_lens,
                 window, k_scale, v_scale)


def _rows(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
          block_tables: torch.Tensor, q_starts: Optional[torch.Tensor],
          ctx_lens: torch.Tensor, window: int,
          k_scale: Optional[torch.Tensor], v_scale: Optional[torch.Tensor]
          ) -> torch.Tensor:
    """The rectangular read on the card (B3); ``q_starts`` None is decode
    (C = 1 at ``ctx_lens - 1``), which the split sweep derives itself."""
    B, C, Hkv, G, D = q.shape
    _check_pools(q, k_pool, v_pool, k_scale, v_scale)
    _check("block_tables", block_tables, q.device, (torch.int32,), 2)
    _check("ctx_lens", ctx_lens, q.device, (torch.int32,), 1)
    if q_starts is not None:
        _check("q_starts", q_starts, q.device, (torch.int32,), 1)
    if block_tables.shape[0] != B or ctx_lens.shape[0] != B or (
            q_starts is not None and q_starts.shape[0] != B):
        raise ValueError(f"block_tables, q_starts and ctx_lens must have "
                         f"B = {B} rows")
    if _tensor_cores(q, k_pool):
        groups = -(-C * G // TC_ROWS)
        max_blocks = block_tables.shape[1]
        tokens = min(C, (TC_ROWS - 1) // G + 2)   # an item's positions
        return _launch_split(
            ROWS_TC, ROWS, q, k_pool, v_pool, k_scale, v_scale,
            (block_tables, ctx_lens, q_starts), B * groups,
            min(C * G, TC_ROWS),
            span_blocks(max_blocks, k_pool.shape[1], window, tokens),
            (B, C, Hkv, G), max_blocks, window, torch.empty_like(q))
    if q_starts is None:
        q_starts = ctx_lens - 1
    group_tokens = max(1, ROW_GROUP // G)
    return _launch(ROWS, group_tokens * G, q, k_pool, v_pool, k_scale,
                   v_scale, (block_tables, ctx_lens, q_starts), (
                       B, C, Hkv, G, group_tokens, k_pool.shape[1],
                       block_tables.shape[1], window),
                   torch.zeros_like(q))


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_tables: torch.Tensor,
                    ctx_lens: torch.Tensor, *, window: int = 0,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decode: q (B, Hkv, G, D), one token per lane at position
    ``ctx_lens - 1``, through the rows kernel with C = 1.  Returns
    (B, Hkv, G, D) in ``q.dtype``."""
    if not q.is_cuda:
        B, Hkv, G, D = q.shape
        out = _ref.paged_attention_reference(
            q.reshape(B, Hkv * G, D), k_pool, v_pool, block_tables,
            ctx_lens, window=window, k_scale=k_scale, v_scale=v_scale)
        return out.reshape(B, Hkv, G, D)
    return _rows(q[:, None], k_pool, v_pool, block_tables, None, ctx_lens,
                 window, k_scale, v_scale)[:, 0]
