"""Serving batch containers: the flat-token stream, its tile map, and
the edge micro-batcher.

The counterpart of ``repro/serving/batch.py``.  Host-only numpy, but for
:class:`BatchEngine`:

  * :class:`RaggedBatch` — the flat-token serving batch: one 1-D stream of
    *all* tokens an engine step schedules (mixed multi-token prefill
    chunks and single-token decodes, each request a contiguous segment)
    plus per-token metadata (owning lane, absolute position, physical KV
    slot).  Bucketing is pow2 on *total tokens*.
  * :class:`TileMap` — the segment-tiled view of a RaggedBatch consumed by
    the tiled paged-attention kernel: the flat stream is cut into fixed
    pow2-sized q-row windows, each window is split at the segment
    boundaries crossing it, and every resulting (window, segment)
    intersection becomes one *tile* that sweeps exactly one lane's KV
    blocks.
  * :class:`BatchEngine` — fixed-shape batched inference of a small edge
    model (BraggNN, the paper's "E" op) with pow2 padding.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device


def padded_pow2(n: int, cap: int = 0) -> int:
    """Smallest power of two >= n (optionally capped).  RaggedBatch pads
    its flat total-token count with this, as the reference does, so both
    packages see the same streams and the same tile maps."""
    size = 1
    while size < n:
        size *= 2
    return min(size, cap) if cap else size


@dataclasses.dataclass
class RaggedBatch:
    """One engine step's scheduled tokens as a flat 1-D stream.

    ``tokens[q_starts[rid] : q_starts[rid] + seg_lens[rid]]`` is request
    ``rid``'s contiguous segment (a prefill chunk, a single decode token,
    or — speculative decode — one feed token followed by ``seg_drafts``
    proposer drafts, verified by the same step's per-row argmax); segments
    are packed back to back in schedule order and the tail is padded to a
    pow2 bucket (capped at the scheduler's token budget).  Per token:

      * ``token_lane``   — owning engine lane (selects the block-table row
        the attention read gathers through);
      * ``token_pos``    — absolute position in its own sequence (RoPE
        anchor + causal bound; in-chunk causality falls out of it);
      * ``slot_mapping`` — physical KV pool slot the token's K/V is
        written to, ``block_id * block_size + offset``.

    Padding tokens carry lane 0 / position 0 / slot 0 (the reserved null
    block): legal targets whose outputs the engine never reads.
    ``last_row[lane]`` is the flat index of that lane's final real token —
    the only logits row that can emit a new token.
    """
    tokens: np.ndarray                 # (T_pad,) int32
    token_lane: np.ndarray             # (T_pad,) int32
    token_pos: np.ndarray              # (T_pad,) int32
    slot_mapping: np.ndarray           # (T_pad,) int32
    last_row: np.ndarray               # (n_lanes,) int32
    q_starts: Dict[int, int]           # request_id -> flat segment offset
    seg_lens: Dict[int, int]           # request_id -> segment length
    # request_id -> trailing speculative draft rows in the segment (a
    # spec decode lane's segment is 1 feed token + seg_drafts[rid]
    # drafts; prefill segments carry 0).  The engine verifies rows
    # [q_starts + seg_lens - seg_drafts - 1, q_starts + seg_lens) of the
    # step's argmax against the drafts.
    seg_drafts: Dict[int, int]
    total_tokens: int                  # real scheduled tokens
    padded_tokens: int                 # bucketed flat length T_pad
    n_draft_tokens: int = 0            # sum of seg_drafts values

    @property
    def padding_efficiency(self) -> float:
        """Real tokens / padded flat slots — 1.0 means zero waste."""
        return self.total_tokens / max(self.padded_tokens, 1)

    @classmethod
    def build(cls, decision, kv, n_lanes: int, block_size: int, *,
              cap: int = 0) -> "RaggedBatch":
        """Flatten a :class:`~repro_torch.serving.scheduler.StepDecision` into
        the per-token arrays the ragged step consumes.  ``kv`` is
        the :class:`KVCacheManager` *after* ``schedule()`` guaranteed every
        scheduled token a slot (block tables are final, incl. any
        copy-on-write repointing).  ``cap`` bounds the pow2 bucket (the
        scheduler's token budget); totals above it are left exact."""
        total = sum(decision.num_scheduled[r.request_id]
                    for r in decision.scheduled)
        if cap and cap < max(total, 1):
            padded = max(total, 1)          # over-budget total: stay exact
        else:
            padded = padded_pow2(max(total, 1), cap)
        tokens = np.zeros((padded,), np.int32)
        token_lane = np.zeros((padded,), np.int32)
        token_pos = np.zeros((padded,), np.int32)
        slot_mapping = np.zeros((padded,), np.int32)
        last_row = np.zeros((n_lanes,), np.int32)
        q_starts: Dict[int, int] = {}
        seg_lens: Dict[int, int] = {}
        seg_drafts: Dict[int, int] = {}
        n_drafts = 0
        off = 0
        for r in decision.scheduled:
            n = decision.num_scheduled[r.request_id]
            table = np.asarray(kv.block_table(r.request_id), np.int64)
            ps = np.arange(r.cursor, r.cursor + n)
            # a speculative decode lane's segment is its feed token plus
            # its draft tokens, at consecutive positions — verification
            # is just this segment riding the ordinary multi-token path
            tokens[off:off + n] = decision.segment_tokens(r)
            token_lane[off:off + n] = r.lane
            token_pos[off:off + n] = ps
            slot_mapping[off:off + n] = (table[ps // block_size] * block_size
                                         + ps % block_size)
            last_row[r.lane] = off + n - 1
            q_starts[r.request_id] = off
            seg_lens[r.request_id] = n
            seg_drafts[r.request_id] = len(
                decision.drafts.get(r.request_id, ()))
            n_drafts += seg_drafts[r.request_id]
            off += n
        return cls(tokens=tokens, token_lane=token_lane,
                   token_pos=token_pos, slot_mapping=slot_mapping,
                   last_row=last_row, q_starts=q_starts, seg_lens=seg_lens,
                   seg_drafts=seg_drafts, total_tokens=total,
                   padded_tokens=padded, n_draft_tokens=n_drafts)

    def tiles(self, n_lanes: int, tile: int) -> "TileMap":
        """The segment-tiled view of this batch (see :class:`TileMap`).
        Segments are recovered from ``q_starts``/``seg_lens`` in stream
        order; lane and first position come from the per-token arrays."""
        segs = sorted((off, self.seg_lens[rid]) for rid, off
                      in self.q_starts.items())
        seg_lanes = [int(self.token_lane[off]) for off, _ in segs]
        seg_pos0 = [int(self.token_pos[off]) for off, _ in segs]
        return build_tile_map([s[0] for s in segs], [s[1] for s in segs],
                              seg_lanes, seg_pos0, self.padded_tokens,
                              n_lanes, tile)


# rows of TileMap.meta — one (5, n_tiles) int32 array per tile map.  The
# kernel layer owns the contract; re-exported here for the serving-side
# builders/tests.
from repro_torch.kernels.ref import (TILE_HI, TILE_LANE,  # noqa: E402,F401
                                     TILE_LO, TILE_POS0, TILE_WINDOW)


@dataclasses.dataclass
class TileMap:
    """Segment-tiled decomposition of one flat token stream.

    The padded stream is covered by ``ceil(padded_tokens / tile)`` fixed
    q-row *windows* of ``tile`` rows each; a window crossing one or more
    segment boundaries is split at them, and every (window, segment)
    intersection is a *tile*.  A tile therefore always lies inside a single
    window (its q rows are one contiguous slab of that window) AND inside a
    single segment (all its rows share one lane / block table, so the
    kernel DMAs that lane's KV blocks once for the whole tile).

    ``meta`` is (5, capacity) int32, row ``r`` of tile ``t``:

      * ``meta[TILE_WINDOW, t]`` — window index (q-row block the tile loads);
      * ``meta[TILE_LO, t]``/``meta[TILE_HI, t]`` — the tile's flat-row span
        ``[lo, hi)``; rows of the window outside it are masked in-kernel;
      * ``meta[TILE_POS0, t]`` — absolute sequence position of row ``lo``
        (row ``q`` sits at ``pos0 + q - lo``: the causal bound);
      * ``meta[TILE_LANE, t]`` — owning lane (block-table row to sweep).

    ``capacity`` is the *static* upper bound ``n_windows + n_lanes`` (each
    of the <= n_lanes segments adds at most one window split), so the
    kernel's grid depends on the pow2 token bucket only, never on the
    tile count.
    Speculative decode needs no extra metadata here: a ``1 + k`` draft
    segment is just a multi-token segment, split at window boundaries and
    swept against its lane's KV exactly like a prefill chunk.
    Tiles past ``n_tiles`` are inert: ``lo == hi`` skips all compute.
    ``row_tile[q]`` maps every real flat row to its owning tile (padding
    rows map to tile 0 — their output is garbage the engine never reads).
    ``cu_seqlens`` (n_segs + 1,) are the segment boundaries in the flat
    stream: segment s is rows ``[cu_seqlens[s], cu_seqlens[s+1])``.
    """
    meta: np.ndarray                   # (5, capacity) int32
    row_tile: np.ndarray               # (padded_tokens,) int32
    cu_seqlens: np.ndarray             # (n_segs + 1,) int32
    n_tiles: int                       # real tiles (<= capacity)
    tile: int                          # q-window row count (pow2)


def build_tile_map(seg_offsets, seg_lens, seg_lanes, seg_pos0,
                   padded_tokens: int, n_lanes: int, tile: int) -> TileMap:
    """Cut back-to-back segments into (window, segment) tiles.

    ``seg_offsets``/``seg_lens``/``seg_lanes``/``seg_pos0`` describe the
    segments in stream order (offsets must be contiguous from 0 — the
    scheduler packs them back to back); ``padded_tokens`` is the bucketed
    flat length the windows must cover.
    """
    if tile < 1 or tile & (tile - 1):
        raise ValueError(f"tile must be a positive power of two, got {tile}")
    n_windows = -(-max(padded_tokens, 1) // tile)
    capacity = n_windows + n_lanes
    meta = np.zeros((5, capacity), np.int32)
    row_tile = np.zeros((padded_tokens,), np.int32)
    cu = [0]
    t = 0
    for off, n, lane, pos0 in zip(seg_offsets, seg_lens, seg_lanes,
                                  seg_pos0):
        if off != cu[-1]:
            raise ValueError(
                f"segments must be contiguous: expected offset {cu[-1]}, "
                f"got {off}")
        cu.append(off + n)
        row = off
        while row < off + n:
            if t >= capacity:
                raise ValueError(
                    f"tile capacity {capacity} exceeded: more than "
                    f"{n_lanes} segments for {n_windows} windows?")
            w = row // tile
            hi = min(off + n, (w + 1) * tile)
            meta[:, t] = (w, row, hi, pos0 + (row - off), lane)
            row_tile[row:hi] = t
            row, t = hi, t + 1
    return TileMap(meta=meta, row_tile=row_tile,
                   cu_seqlens=np.asarray(cu, np.int32), n_tiles=t, tile=tile)


@dataclasses.dataclass
class BatchStats:
    """Rolling counters for :class:`BatchEngine` (requests, batches, latency)."""

    n_requests: int = 0
    n_batches: int = 0
    total_items: int = 0
    total_latency: float = 0.0

    def summary(self) -> Dict[str, float]:
        """Counters plus mean per-batch latency, as a plain dict."""
        return {
            "requests": self.n_requests,
            "batches": self.n_batches,
            "items": self.total_items,
            "mean_latency_s": self.total_latency / max(self.n_batches, 1),
        }


class BatchEngine:
    """Fixed-shape batched inference with padding.

    ``apply_fn(params, x) -> y`` runs eagerly under
    ``torch.inference_mode()`` on the engine's device; a request of any
    size is cut into chunks of at most ``max_batch`` rows, each padded with
    zeros to a power of two (so the model sees at most log2(max_batch) + 1
    shapes, as the reference compiles once per size).
    """

    def __init__(self, apply_fn: Callable, params: Any, *,
                 max_batch: int = 1024, device="cuda") -> None:
        """``params`` must already live on ``device``."""
        self.params = params
        self.max_batch = max_batch
        self.apply_fn = apply_fn
        self.device = resolve_device(device)
        self.stats = BatchStats()

    def infer(self, x: np.ndarray) -> np.ndarray:
        """Process a request of any size by padded fixed-shape batches;
        returns numpy.  Latency per batch covers the copy in, the model
        and the copy out."""
        self.stats.n_requests += 1
        outs = []
        i = 0
        n = x.shape[0]
        while i < n:
            take = min(self.max_batch, n - i)
            size = padded_pow2(take, self.max_batch)
            chunk = x[i:i + take]
            if take < size:
                pad = np.zeros((size - take,) + x.shape[1:], x.dtype)
                chunk = np.concatenate([chunk, pad])
            t0 = time.perf_counter()
            with torch.inference_mode():
                xin = torch.from_numpy(np.ascontiguousarray(chunk)).to(
                    self.device)
                y = self.apply_fn(self.params, xin).cpu().numpy()
            self.stats.total_latency += time.perf_counter() - t0
            self.stats.n_batches += 1
            self.stats.total_items += take
            outs.append(y[:take])
            i += take
        return np.concatenate(outs) if len(outs) > 1 else outs[0]
