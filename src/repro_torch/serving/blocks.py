"""Block-based (paged) KV cache bookkeeping — the vLLM idea in host code.

Host-only (numpy + stdlib): a near-verbatim copy of the reference
package's ``serving/blocks.py``, kept separate so the port never imports
the JAX package.  The differential tests hold both copies to the same
block tables, refcounts and digests under the same request traces.

A request's logical KV sequence is mapped onto fixed-size *physical* blocks
drawn from a shared pool, so memory is committed one block at a time as the
sequence grows instead of one dense ``cache_len`` slab per slot.  Two layers:

  * :class:`BlockAllocator` — the physical pool: a free-list plus per-block
    reference counts (refcount > 1 means the block is shared between
    sequences, e.g. a forked or prefix-matched block).
  * :class:`KVCacheManager` — per-sequence logical->physical block tables
    with ``allocate`` / ``append_token`` / ``rewind`` / ``free`` / ``fork``
    APIs, and the padded numpy block-table matrix the jitted decode step
    consumes.  ``rewind`` is the speculative-decode rollback: it drops a
    sequence's tail back to the accepted watermark, freeing blocks that
    only held rejected draft tokens and leaving the pool (and the prefix
    cache) exactly as if only the accepted tokens had been appended.

Physical block 0 is reserved as the *null block*: idle engine lanes point
their table at it so the jitted scatter always has a legal target, and no
live sequence is ever given block 0.

All bookkeeping here is in terms of *global* block ids, and that is a
load-bearing contract for mesh-sharded serving: a sharded engine cuts
only the ``kv_heads`` axis of the device pools, never the block axis, so
every shard holds its head slice of **every** block and this module's
tables/refcounts/digests describe all shards at once (the per-shard pool
invariant, ``docs/ARCHITECTURE.md`` §7).  Data-parallel slices each own
a full private allocator — nothing here is shared between slices.

Prefix sharing (``enable_prefix_cache=True``): every *full* block is
content-hashed over its token ids chained to its prefix
(``digest = H(parent_digest, block_tokens)``), and the manager keeps one
reference of its own on each registered block.  A newly admitted sequence
(:meth:`begin_seq`) walks its feed block-by-block through the hash table and
*attaches* the longest chain of matching full blocks instead of recomputing
them; partially-filled blocks are never returned by the lookup.  Blocks whose
only remaining reference is the cache's own hold are *evictable*: they are
reclaimed LRU-first when the free list runs dry, so cached prefixes never
block admissions.  Writing into a block that is still shared (refcount > 1 —
e.g. the tail block of a fully-matched prompt whose last token must be
re-processed to produce logits) triggers **copy-on-write**: a fresh block is
allocated, a ``(src, dst)`` device-copy op is queued for the engine to apply
to the KV pools before its next step, and the sequence's table is repointed.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

NULL_BLOCK = 0


class BlockAllocator:
    """Free-list allocator with reference counting over a fixed pool.

    Block ids run ``1..num_blocks-1`` (0 is the reserved null block).
    """

    def __init__(self, num_blocks: int) -> None:
        """Create a pool of ``num_blocks`` blocks (block 0 stays reserved)."""
        if num_blocks < 2:
            raise ValueError("need at least 2 blocks (one is the null block)")
        self.num_blocks = num_blocks
        self._free: deque[int] = deque(range(1, num_blocks))
        self._refs: Dict[int, int] = {}

    @property
    def num_free(self) -> int:
        """Blocks on the free list (excludes cache-held evictable blocks)."""
        return len(self._free)

    @property
    def num_allocated(self) -> int:
        """Blocks currently holding at least one reference."""
        return len(self._refs)

    def allocate(self) -> int:
        """Pop a free block (refcount 1); RuntimeError when the pool is dry."""
        if not self._free:
            raise RuntimeError("out of KV cache blocks")
        blk = self._free.popleft()
        self._refs[blk] = 1
        return blk

    def refcount(self, block_id: int) -> int:
        """Current reference count of ``block_id`` (0 if unallocated)."""
        return self._refs.get(block_id, 0)

    def incref(self, block_id: int) -> None:
        """Add one reference to an allocated block."""
        if block_id not in self._refs:
            raise KeyError(f"block {block_id} is not allocated")
        self._refs[block_id] += 1

    def decref(self, block_id: int) -> None:
        """Drop one reference; the block returns to the free list at zero."""
        if block_id not in self._refs:
            raise KeyError(f"block {block_id} is not allocated")
        self._refs[block_id] -= 1
        if self._refs[block_id] == 0:
            del self._refs[block_id]
            self._free.append(block_id)


@dataclasses.dataclass
class SeqBlocks:
    """One sequence's logical view: table[i] holds tokens [i*bs, (i+1)*bs).

    ``digests`` is the hash chain of this sequence's *completed* full blocks
    and ``pending`` the token ids of the current partial block — both only
    maintained when the prefix cache is on and token contents are known
    (``pending is None`` marks the sequence unhashable).  ``history`` is
    the full token-id record (attached prefix + every appended token),
    kept in lockstep with ``pending`` so :meth:`KVCacheManager.rewind` can
    rebuild the partial-block hash state after a speculative rollback
    crosses a block boundary.
    """
    table: List[int] = dataclasses.field(default_factory=list)
    n_tokens: int = 0
    digests: List[str] = dataclasses.field(default_factory=list)
    pending: Optional[List[int]] = None
    history: Optional[List[int]] = None
    # chain indexes (positions in ``digests``) whose cache registration
    # THIS sequence created (vs attached/pre-existing content) — the set
    # :meth:`KVCacheManager.rewind` must un-register when those blocks
    # turn out to hold rejected speculative tokens
    registered: set = dataclasses.field(default_factory=set)


def chain_digest(parent: str, tokens: Sequence[int]) -> str:
    """Content hash of one full KV block chained to its prefix.

    ``parent`` is the previous block's chain digest (``""`` for the first
    block of a sequence), ``tokens`` the block's token ids.  The digest
    therefore identifies the *entire token prefix* up to and including
    this block, not just the block's own contents — two sequences share a
    digest iff they share every token from position 0.  Pure function of
    the token ids (sha256 over little-endian int64 bytes), so digests are
    stable across processes and hosts: the prefix cache, the KV-block
    wire format (``serving/transfer.py``) and the on-disk prefix-cache
    persistence format all key on the same value.
    """
    h = hashlib.sha256()
    h.update(parent.encode())
    h.update(np.asarray(tokens, np.int64).tobytes())
    return h.hexdigest()


_digest = chain_digest


class KVCacheManager:
    """Maps logical KV sequences onto the physical block pool.

    ``block_size`` tokens per block; ``max_blocks_per_seq`` bounds a single
    sequence (the engine's ``cache_len`` ceiling).  All model layers share
    one block table per sequence — a physical block id indexes every layer's
    pool at once.
    """

    def __init__(self, num_blocks: int, block_size: int, *,
                 max_blocks_per_seq: int,
                 enable_prefix_cache: bool = False) -> None:
        """Build the manager over a fresh ``num_blocks``-block pool."""
        self.allocator = BlockAllocator(num_blocks)
        self.block_size = block_size
        self.max_blocks_per_seq = max_blocks_per_seq
        self.enable_prefix_cache = enable_prefix_cache
        self._seqs: Dict[int, SeqBlocks] = {}
        # prefix cache state: digest -> block, block -> digest, LRU of
        # blocks whose only reference is the cache's own hold
        self._cached: Dict[str, int] = {}
        self._block_digest: Dict[int, str] = {}
        # digest -> (parent digest, block tokens): the provenance needed to
        # export a cached block onto the wire (or to disk) and to recompute
        # its chain digest on the receiving side
        self._cached_meta: Dict[str, Tuple[str, Tuple[int, ...]]] = {}
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        self._copy_ops: List[Tuple[int, int]] = []
        self.prefix_hits = 0
        self.prefix_tokens_reused = 0
        self.cow_copies = 0
        self.evictions = 0
        # speculative-rollback accounting (rewind calls that dropped >= 1
        # token; blocks_rewound counts blocks freed because they only held
        # rejected tokens)
        self.rewinds = 0
        self.tokens_rewound = 0
        self.blocks_rewound = 0
        # bumped whenever the set of cached digests changes — lets the
        # scheduler skip re-hashing a blocked prompt when nothing moved
        self.cache_version = 0
        # can_admit -> begin_seq handoff: the admission plan for one feed,
        # so back-to-back check+admit hashes the prompt once, not twice
        self._plan_cache = None
        # tiered-KV hooks, installed by the engine when the host swap tier
        # is on: ``host_has(digest) -> bool`` says a full block's payload is
        # resident in the host pool (so admission can swap it in instead of
        # recomputing); ``on_swap_out(digest, blk, parent, tokens)`` fires
        # just before an eviction drops a registered block, while its
        # device payload is still addressable
        self.host_has = None
        self.on_swap_out = None
        self._swap_in_ops: List[Tuple[str, int]] = []
        self.swap_ins = 0
        self.swapped_in_tokens = 0
        # cancellation accounting (release_seq / release_chain)
        self.released_seqs = 0
        self.swap_ins_dropped = 0

    # ------------------------------------------------------------------
    def _protected_blocks(self) -> frozenset:
        """Device blocks a still-valid admission plan counted as prefix
        hits.  Evicting one silently converts the planned cache hit into a
        recompute, so the accounting below shields them while the plan is
        live (a stale plan — cache_version moved on — protects nothing)."""
        plan = self._plan_cache
        if plan is None or plan[1] != self.cache_version:
            return frozenset()
        return frozenset(b for b in plan[3] if b is not None)

    def free_blocks(self, protect: frozenset = frozenset(), *,
                    planned: bool = True) -> int:
        """THE free-block accounting rule: free-list blocks plus cache-only
        (LRU) blocks, excluding ``protect`` and — unless ``planned=False``
        — blocks shielded by a live admission plan.  ``num_free_blocks``,
        ``can_admit``/``_plan_admission`` and the scheduler's slot-guarantee
        loop all route through here, so "how many blocks can I still draw"
        has exactly one answer everywhere."""
        guard = frozenset(protect) | \
            (self._protected_blocks() if planned else frozenset())
        if not guard:
            return self.allocator.num_free + len(self._lru)
        return self.allocator.num_free + sum(
            1 for b in self._lru if b not in guard)

    def drop_plan_protection(self) -> None:
        """Surrender the cached admission plan (and the eviction shield on
        its prefix hits).  The scheduler calls this when every reclaimable
        block is a planned hit and the alternative is preempting live work
        — the plan's owner re-plans on its next admission attempt."""
        self._plan_cache = None

    @property
    def num_free_blocks(self) -> int:
        """Blocks available for new allocations: the free list plus cached
        blocks no live sequence references (evicted on demand), minus any
        blocks a live admission plan counted as prefix hits."""
        return self.free_blocks()

    def n_tokens(self, seq_id: int) -> int:
        """Current logical length of sequence ``seq_id`` in tokens."""
        return self._seqs[seq_id].n_tokens

    def has_seq(self, seq_id: int) -> bool:
        """True when ``seq_id`` is registered with the manager."""
        return seq_id in self._seqs

    def blocks_needed(self, n_tokens: int) -> int:
        """Physical blocks required to hold ``n_tokens`` tokens (ceil)."""
        return -(-n_tokens // self.block_size)          # ceil

    def can_allocate(self, n_tokens: int) -> bool:
        """Prefix-blind admission check against free + evictable blocks."""
        need = self.blocks_needed(n_tokens)
        if need > self.max_blocks_per_seq:
            raise ValueError(
                f"sequence of {n_tokens} tokens needs {need} blocks, over the "
                f"per-seq ceiling {self.max_blocks_per_seq}")
        return need <= self.num_free_blocks

    # ------------------------------------------------------------------
    # internal pool plumbing (eviction-aware)
    # ------------------------------------------------------------------
    def _evict_one(self, protect: frozenset = frozenset()) -> bool:
        """Reclaim the coldest cache-only block that is neither in
        ``protect`` nor shielded by a live admission plan.  When the swap
        hook is installed the block's payload is offered to the host tier
        first (its device bytes are still addressable here — eviction only
        ever reclaims blocks whose content landed in an earlier step).
        Returns False when every LRU block is protected."""
        guard = frozenset(protect) | self._protected_blocks()
        blk = next((b for b in self._lru if b not in guard), None)
        if blk is None:
            return False
        self._lru.pop(blk)
        digest = self._block_digest.pop(blk)
        if self.on_swap_out is not None:
            parent, tokens = self._cached_meta.get(digest, ("", ()))
            if tokens:
                self.on_swap_out(digest, blk, parent, tokens)
        del self._cached[digest]
        self._cached_meta.pop(digest, None)
        self.allocator.decref(blk)          # drop the cache's hold -> free
        self.evictions += 1
        self.cache_version += 1
        return True

    def _alloc_block(self, protect: frozenset = frozenset()) -> int:
        if self.allocator.num_free == 0 and self._lru:
            self._evict_one(protect)
        return self.allocator.allocate()

    def _attach(self, blk: int) -> None:
        """Take a sequence reference on an existing (cached) block."""
        self.allocator.incref(blk)
        self._lru.pop(blk, None)            # in use again: not evictable

    def _release(self, blk: int) -> None:
        """Drop a sequence reference; cache-held blocks become evictable."""
        self.allocator.decref(blk)
        if blk in self._block_digest and self.allocator.refcount(blk) == 1:
            self._lru[blk] = None
            self._lru.move_to_end(blk)

    def _register_full_block(self, seq: SeqBlocks) -> None:
        """The sequence just completed a full block: chain-hash it and (if
        this content is new) register the block for prefix sharing."""
        parent = seq.digests[-1] if seq.digests else ""
        tokens = seq.pending
        digest = _digest(parent, tokens)
        seq.digests.append(digest)
        seq.pending = []
        if digest in self._cached:
            return                          # identical content already cached
        blk = seq.table[(seq.n_tokens - 1) // self.block_size]
        self._cached[digest] = blk
        self._block_digest[blk] = digest
        self._cached_meta[digest] = (parent, tuple(tokens))
        self.allocator.incref(blk)          # the cache's own hold
        seq.registered.add(len(seq.digests) - 1)
        self.cache_version += 1

    def _match_prefix(self, feed: Sequence[int]
                      ) -> Tuple[List[str], List[Optional[int]]]:
        """Longest chain of *full* blocks covering a prefix of feed.

        Each source is a device block id for a device-resident hit, or
        ``None`` for a host-tier hit (the payload lives in the engine's
        host pool and must be swapped into a fresh device block — cheaper
        than recomputing it, but it does consume a pool block)."""
        digests: List[str] = []
        sources: List[Optional[int]] = []
        parent = ""
        bs = self.block_size
        for i in range(0, len(feed) - len(feed) % bs, bs):
            d = _digest(parent, feed[i:i + bs])
            blk = self._cached.get(d)
            if blk is None and (self.host_has is None
                                or not self.host_has(d)):
                break
            digests.append(d)
            sources.append(blk)
            parent = d
        return digests, sources

    # ------------------------------------------------------------------
    def lookup_prefix(self, feed: Sequence[int]) -> int:
        """Number of feed tokens covered by cached full blocks (always a
        multiple of ``block_size`` — partially-filled blocks never match)."""
        if not self.enable_prefix_cache:
            return 0
        _, sources = self._match_prefix([int(t) for t in feed])
        return len(sources) * self.block_size

    # ------------------------------------------------------------------
    # transfer / persistence hooks (the engine's KV export and import)
    # ------------------------------------------------------------------
    def has_digest(self, digest: str) -> bool:
        """True when a full block with this chain digest is cached."""
        return digest in self._cached

    def cached_digests(self) -> frozenset:
        """Chain digests of every full block the prefix cache holds."""
        return frozenset(self._cached)

    def export_chain(self, feed: Sequence[int]
                     ) -> List[Tuple[str, str, int, List[int]]]:
        """Walk ``feed`` through the cache and export the longest chain of
        cached full blocks covering its prefix.

        Returns ``[(digest, parent_digest, physical_block, tokens), ...]``
        in chain order (parents before children).  The physical block ids
        let the engine read the actual KV payloads off the device pools;
        the (parent, tokens) pairs are everything a receiver needs to
        recompute and verify the digests.  Stops at the first un-cached
        block, exactly like prefix matching at admission.
        """
        out: List[Tuple[str, str, int, List[int]]] = []
        parent = ""
        bs = self.block_size
        feed = [int(t) for t in feed]
        for i in range(0, len(feed) - len(feed) % bs, bs):
            tokens = feed[i:i + bs]
            d = _digest(parent, tokens)
            blk = self._cached.get(d)
            if blk is None:
                break
            out.append((d, parent, blk, tokens))
            parent = d
        return out

    def export_all_cached(self) -> List[Tuple[str, str, int, List[int]]]:
        """Export every cached full block, as :meth:`export_chain` tuples.

        Registration order is preserved, which puts parents before their
        children for chains built by a single sequence; a chain whose
        parent was LRU-evicted exports as an orphan that simply never
        matches on the importing side (harmless dead weight, evicted there
        in turn).  This is the prefix-cache persistence path: serialize
        the result as a ``KVShipment`` (``serving/transfer.py``) and the
        wire format doubles as the on-disk format.
        """
        out: List[Tuple[str, str, int, List[int]]] = []
        for digest, blk in self._cached.items():
            parent, tokens = self._cached_meta[digest]
            out.append((digest, parent, blk, list(tokens)))
        return out

    def import_block(self, parent: str, tokens: Sequence[int], *,
                     digest: Optional[str] = None) -> Optional[int]:
        """Register one full block arriving from another engine (or disk).

        Allocates a physical block, registers it under
        ``chain_digest(parent, tokens)`` exactly as if a local sequence had
        completed it, and returns the block id so the caller can write the
        KV payload into the device pools.  The cache's own hold is the only
        reference, so the imported block goes straight onto the LRU — it is
        evictable and never crowds out live sequences, though importing can
        itself evict cold cached blocks when the free list is dry.

        Returns ``None`` when the digest is already cached (the dedup-skip:
        content-addressing makes re-imports free).  ``digest``, when given,
        is cross-checked against the recomputed chain digest — a mismatch
        means the token history was corrupted in flight and raises
        ``ValueError``.  Raises ``RuntimeError`` when live sequences hold
        the whole pool and nothing is evictable.
        """
        if not self.enable_prefix_cache:
            raise RuntimeError("import_block requires enable_prefix_cache")
        tokens = [int(t) for t in tokens]
        if len(tokens) != self.block_size:
            raise ValueError(
                f"imported block has {len(tokens)} tokens, expected a full "
                f"block of {self.block_size}")
        d = _digest(parent, tokens)
        if digest is not None and digest != d:
            raise ValueError(
                "chain digest mismatch: token history does not hash to the "
                "advertised digest")
        if d in self._cached:
            return None
        blk = self._alloc_block()
        self._cached[d] = blk
        self._block_digest[blk] = d
        self._cached_meta[d] = (parent, tuple(tokens))
        # sole ref is the cache's hold -> immediately evictable
        self._lru[blk] = None
        self._lru.move_to_end(blk)
        self.cache_version += 1
        return blk

    def _plan_admission(self, feed: Sequence[int]
                        ) -> Tuple[List[str], List[Optional[int]], int]:
        """Choose the cached prefix blocks a new sequence would attach.
        Returns (digests, sources, num_computed); sources holds device
        block ids, with ``None`` marking host-tier hits that swap in.  A
        full-feed match forces the capped last token's write into the
        shared tail block (a copy-on-write fork needing one extra block);
        when the pool cannot afford that fork — or the tail hit is
        host-resident, where a swap-in PLUS a fork costs more than just
        recomputing one block — the last matched block is dropped from the
        plan, so the tail recomputes into a fresh/evicted block instead."""
        digests, sources = self._match_prefix(feed)
        matched = len(sources) * self.block_size
        num_computed = min(matched, len(feed) - 1)
        if num_computed < matched:       # full match -> CoW on first write
            shared = frozenset(s for s in sources if s is not None)
            avail = self.free_blocks(protect=shared, planned=False)
            if sources[-1] is None or avail < 1:
                digests, sources = digests[:-1], sources[:-1]
                num_computed = len(sources) * self.block_size
        return digests, sources, num_computed

    def can_admit(self, feed: Sequence[int]) -> bool:
        """Prefix-aware admission check: can the pool cover ``feed`` given
        the full blocks a prefix match would share (plus the copy-on-write
        fork a fully-matched prompt needs)?  Host-tier hits save compute
        but still draw a device block each, so they count as allocations
        here."""
        need = self.blocks_needed(len(feed))
        if need > self.max_blocks_per_seq:
            raise ValueError(
                f"sequence of {len(feed)} tokens needs {need} blocks, over "
                f"the per-seq ceiling {self.max_blocks_per_seq}")
        if not self.enable_prefix_cache or need <= self.allocator.num_free:
            # fast path also skips re-hashing a blocked prompt every step
            return need <= self.num_free_blocks
        feed = [int(t) for t in feed]
        digests, sources, num_computed = self._plan_admission(feed)
        self._plan_cache = (feed, self.cache_version,
                            digests, sources, num_computed)
        extra = 1 if num_computed < len(sources) * self.block_size else 0
        n_device = sum(1 for s in sources if s is not None)
        shared = frozenset(s for s in sources if s is not None)
        return need - n_device + extra \
            <= self.free_blocks(protect=shared, planned=False)

    def begin_seq(self, seq_id: int, feed: Sequence[int]) -> int:
        """Register a sequence, sharing the longest cached prefix of its
        feed.  Returns the number of already-computed tokens (the caller's
        cursor start) — capped at ``len(feed) - 1`` so at least one token is
        processed to produce logits.  When that cap lands mid-block the
        shared tail block is attached anyway; the first write into it
        triggers copy-on-write."""
        if seq_id in self._seqs:
            raise KeyError(f"seq {seq_id} already allocated")
        if not self.enable_prefix_cache or not len(feed):
            self.allocate(seq_id, 0)
            return 0
        feed = [int(t) for t in feed]
        cached = self._plan_cache
        self._plan_cache = None
        if cached and cached[0] == feed and cached[1] == self.cache_version:
            digests, sources, num_computed = cached[2:]
        else:
            digests, sources, num_computed = self._plan_admission(feed)
        n_attach = self.blocks_needed(num_computed)
        sources = sources[:n_attach]
        shared = frozenset(s for s in sources if s is not None)
        bs = self.block_size
        table: List[int] = []
        for i, src in enumerate(sources):
            if src is not None:
                self._attach(src)
                table.append(src)
                continue
            # host-tier hit: draw a fresh device block (never evicting a
            # device hit of this same plan) and register it under the
            # chain digest exactly as if a local sequence had completed
            # it; the engine writes the host payload into the block
            # before the next step reads it (take_swap_ins)
            blk = self._alloc_block(protect=shared)
            self._cached[digests[i]] = blk
            self._block_digest[blk] = digests[i]
            self._cached_meta[digests[i]] = (
                digests[i - 1] if i else "",
                tuple(feed[i * bs:(i + 1) * bs]))
            self.allocator.incref(blk)      # the cache's own hold
            self._swap_in_ops.append((digests[i], blk))
            self.swap_ins += 1
            self.swapped_in_tokens += bs
            self.cache_version += 1
            table.append(blk)
        n_full = num_computed // bs
        seq = SeqBlocks(table=table, n_tokens=num_computed,
                        digests=digests[:n_full],
                        pending=feed[n_full * bs:num_computed],
                        history=feed[:num_computed])
        self._seqs[seq_id] = seq
        if num_computed:
            self.prefix_hits += 1
            self.prefix_tokens_reused += num_computed
        return num_computed

    def take_swap_ins(self) -> List[Tuple[str, int]]:
        """Drain queued host->device swap-ins as ``(digest, block)`` pairs.
        The engine must write each digest's host payload into the device
        pools before its next step (and before applying CoW copies — a
        stale swap-in target that was recycled as a CoW destination must
        end up holding the copy, not the host bytes)."""
        ops, self._swap_in_ops = self._swap_in_ops, []
        return ops

    def digest_block(self, digest: str) -> Optional[int]:
        """Device block currently registered under ``digest`` (None when
        evicted) — lets the engine drop swap-in writes whose target block
        was reclaimed before the payload landed."""
        return self._cached.get(digest)

    def seq_swap_preserved(self, seq_id: int) -> int:
        """Full blocks of ``seq_id`` whose contents survive a ``free()``:
        they are registered in the prefix cache, so with the host swap
        tier installed a preemption degrades to a swap-out (re-admission
        swaps them back in) instead of a recompute."""
        seq = self._seqs.get(seq_id)
        if seq is None or seq.pending is None:
            return 0
        return sum(1 for d in seq.digests if d in self._cached)

    def take_copy_ops(self) -> List[Tuple[int, int]]:
        """Drain queued copy-on-write ``(src, dst)`` block copies.  The
        engine must apply them to the device KV pools before its next step
        writes into the ``dst`` blocks."""
        ops, self._copy_ops = self._copy_ops, []
        return ops

    # ------------------------------------------------------------------
    def allocate(self, seq_id: int, n_tokens: int = 0) -> None:
        """Register a sequence and pre-allocate blocks for n_tokens."""
        if seq_id in self._seqs:
            raise KeyError(f"seq {seq_id} already allocated")
        need = self.blocks_needed(n_tokens)
        if need > self.num_free_blocks:
            raise RuntimeError(
                f"seq {seq_id} needs {need} blocks, "
                f"{self.num_free_blocks} free")
        # pre-allocated contents are unknown: such sequences are unhashable
        hashable = self.enable_prefix_cache and n_tokens == 0
        seq = SeqBlocks(pending=[] if hashable else None,
                        history=[] if hashable else None)
        for _ in range(need):
            seq.table.append(self._alloc_block())
        seq.n_tokens = n_tokens
        self._seqs[seq_id] = seq

    def append_needs_block(self, seq_id: int) -> bool:
        """True when the next ``append_token`` must draw a block from the
        pool — either crossing into a new logical block, or a copy-on-write
        of a shared tail block."""
        seq = self._seqs[seq_id]
        bi = seq.n_tokens // self.block_size
        if bi >= len(seq.table):
            return True
        return self.allocator.refcount(seq.table[bi]) > 1

    def append_token(self, seq_id: int,
                     token: Optional[int] = None) -> Optional[int]:
        """Grow the sequence by one token; returns the newly allocated
        physical block id when the token crosses a block boundary (or a
        copy-on-write replaced the shared tail block), else None.  Raises
        RuntimeError when the pool is exhausted (the scheduler turns that
        into a preemption).  ``token`` is the id being appended — needed for
        prefix-cache hashing; hashing is disabled for the sequence when
        omitted."""
        seq = self._seqs[seq_id]
        bi = seq.n_tokens // self.block_size
        new_block: Optional[int] = None
        if bi >= len(seq.table):
            if len(seq.table) >= self.max_blocks_per_seq:
                raise ValueError(
                    f"seq {seq_id} exceeds max_blocks_per_seq "
                    f"({self.max_blocks_per_seq})")
            new_block = self._alloc_block()
            seq.table.append(new_block)
        else:
            blk = seq.table[bi]
            if self.allocator.refcount(blk) > 1:
                # copy-on-write: the tail block is shared (other sequences
                # and/or the cache hold it) — never write into it
                new_block = self._alloc_block()
                self._copy_ops.append((blk, new_block))
                self._release(blk)
                seq.table[bi] = new_block
                self.cow_copies += 1
        seq.n_tokens += 1
        if seq.pending is not None:
            if token is None:
                seq.pending = None          # content unknown: stop hashing
                seq.history = None
            else:
                seq.pending.append(int(token))
                seq.history.append(int(token))
                if len(seq.pending) == self.block_size:
                    self._register_full_block(seq)
        return new_block

    def rewind(self, seq_id: int, n_tokens: int) -> None:
        """Roll a sequence's tail back to ``n_tokens`` — the speculative
        decode rollback: tokens past the new end (rejected drafts) are
        logically dropped.

        Blocks that only held rejected tokens are released (a shared or
        cache-held block is only decref'd, never reclaimed or mutated in
        place — copy-on-write still protects any other holder).  Cache
        registrations THIS sequence created for now-rejected full blocks
        are un-registered, so the prefix cache ends up exactly as if only
        the accepted tokens had ever been appended; registrations that
        pre-existed (attached prefixes, content another sequence cached
        first) are left alone.  The digest chain is truncated and the
        partial-block hash state rebuilt from the retained token history,
        so a later re-completion of the tail block re-hashes cleanly.
        Stale KV left in the retained tail block's upper slots is
        unreachable: every attention read masks positions past the
        query's own, and the next appends overwrite (or CoW-fork) those
        slots before they are ever covered."""
        seq = self._seqs[seq_id]
        if not 0 <= n_tokens <= seq.n_tokens:
            raise ValueError(
                f"cannot rewind seq {seq_id} to {n_tokens} tokens "
                f"(has {seq.n_tokens})")
        if n_tokens == seq.n_tokens:
            return
        self.rewinds += 1
        self.tokens_rewound += seq.n_tokens - n_tokens
        if seq.pending is not None:
            n_full = n_tokens // self.block_size
            for idx in [i for i in seq.registered if i >= n_full]:
                seq.registered.discard(idx)
                digest = seq.digests[idx]
                blk = self._cached.get(digest)
                if blk is not None and \
                        self._block_digest.get(blk) == digest:
                    del self._cached[digest]
                    del self._block_digest[blk]
                    self._cached_meta.pop(digest, None)
                    self._lru.pop(blk, None)
                    self.allocator.decref(blk)  # drop the cache's hold
                    self.cache_version += 1
            del seq.digests[n_full:]
            seq.pending = list(
                seq.history[n_full * self.block_size:n_tokens])
            del seq.history[n_tokens:]
        keep = self.blocks_needed(n_tokens)
        for blk in seq.table[keep:]:
            # blocks_rewound counts only blocks actually reclaimed: a
            # block still shared (fork / prefix attach) is merely
            # decref'd and stays allocated for its other holders
            if self.allocator.refcount(blk) == 1:
                self.blocks_rewound += 1
            self._release(blk)
        del seq.table[keep:]
        seq.n_tokens = n_tokens

    def free(self, seq_id: int) -> None:
        """Drop a finished sequence's references.  Blocks the prefix cache
        registered stay resident (the cache's own hold keeps them) and
        become evictable; unshared blocks return to the free list."""
        seq = self._seqs.pop(seq_id)
        for blk in seq.table:
            self._release(blk)

    def _unregister(self, digest: str, blk: int) -> None:
        """Drop one prefix-cache registration and the cache's block hold."""
        del self._cached[digest]
        del self._block_digest[blk]
        self._cached_meta.pop(digest, None)
        self._lru.pop(blk, None)
        self.allocator.decref(blk)          # drop the cache's hold
        self.cache_version += 1

    def _drop_stale_swap_ins(self) -> None:
        """Drop queued host->device swap-ins whose target block no longer
        holds the registration they were queued against — the cancellation
        path un-registers blocks mid-flight, and writing a host payload
        into a block that has since been freed (or recycled) would corrupt
        whoever owns it now.  Ops whose registration is intact (e.g. a
        swap-in block another live sequence attached to) are kept."""
        keep: List[Tuple[str, int]] = []
        for d, blk in self._swap_in_ops:
            if self._cached.get(d) != blk:
                self.swap_ins_dropped += 1
            else:
                keep.append((d, blk))
        self._swap_in_ops = keep

    def release_seq(self, seq_id: int) -> List[str]:
        """Cancellation teardown for a live sequence: free its blocks AND
        un-register the chain blocks only it (plus the cache) was holding,
        so a cancelled request leaves no KV residue behind.

        Contrast with :meth:`free` (normal completion), which deliberately
        leaves the chain registered for future prefix hits.  A cancelled
        request's chain is dead weight *unless another holder is alive*:
        a block whose refcount exceeds 2 (this seq + the cache's hold)
        is shared with another live sequence, so its registration — and
        any pending swap-in payload write targeting it — survives; the
        last cancelling holder takes it down.  Queued swap-ins whose
        registration this call removed are dropped (``swap_ins_dropped``),
        and any cached admission plan is surrendered (its free-block
        shield must not outlive a cancellation that changed the pool).

        Returns the chain digests no longer device-registered afterwards —
        the engine purges exactly these from the host swap tier.
        """
        seq = self._seqs[seq_id]
        owned = set(seq.table)
        for digest in seq.digests:
            blk = self._cached.get(digest)
            if blk is None or self._block_digest.get(blk) != digest:
                continue
            if blk in owned and self.allocator.refcount(blk) == 2:
                self._unregister(digest, blk)
        purge = [d for d in seq.digests if d not in self._cached]
        self.free(seq_id)
        self._drop_stale_swap_ins()
        self._plan_cache = None
        self.released_seqs += 1
        return purge

    def release_chain(self, feed: Sequence[int]) -> List[str]:
        """Cancellation teardown for a request with no live sequence (still
        waiting, or preempted with its KV swapped out): walk the feed's
        chain and reclaim cache-only device blocks, collecting the digests
        whose payloads now live only in the host tier so the engine can
        purge them.  Blocks still referenced by a live sequence are left
        registered (that sequence's own release handles them later).

        The walk does NOT stop at the first missing block: an earlier
        cancellation may have unregistered a shared chain *head* while
        deeper blocks of this chain still sit in the host tier (eviction
        order is LRU, not chain order) — those deep entries are
        unreachable garbage (admission matches from the head), so the
        walk covers every full block of the feed.
        """
        if not self.enable_prefix_cache:
            return []
        feed = [int(t) for t in feed]
        purge: List[str] = []
        parent = ""
        bs = self.block_size
        for i in range(0, len(feed) - len(feed) % bs, bs):
            d = _digest(parent, feed[i:i + bs])
            blk = self._cached.get(d)
            if blk is not None:
                if self._block_digest.get(blk) == d \
                        and self.allocator.refcount(blk) == 1:
                    self._unregister(d, blk)
                    purge.append(d)
            elif self.host_has is not None and self.host_has(d):
                purge.append(d)
            parent = d
        self._drop_stale_swap_ins()
        self._plan_cache = None
        return purge

    def fork(self, src_seq_id: int, dst_seq_id: int) -> None:
        """Share the source's blocks with a new sequence (refcounted).

        Forks are only allowed at block-aligned lengths; a later write into
        any still-shared block copy-on-writes it (see ``append_token``).
        """
        src = self._seqs[src_seq_id]
        if src.n_tokens % self.block_size != 0:
            raise ValueError("fork requires a block-aligned source length")
        if dst_seq_id in self._seqs:
            raise KeyError(f"seq {dst_seq_id} already allocated")
        dst = SeqBlocks(table=list(src.table), n_tokens=src.n_tokens,
                        digests=list(src.digests),
                        pending=None if src.pending is None
                        else list(src.pending),
                        history=None if src.history is None
                        else list(src.history))
        for blk in dst.table:
            self._attach(blk)
        self._seqs[dst_seq_id] = dst

    # ------------------------------------------------------------------
    def block_table(self, seq_id: int) -> List[int]:
        """Copy of the sequence's logical->physical block table."""
        return list(self._seqs[seq_id].table)

    def padded_table(self, seq_id: int) -> np.ndarray:
        """(max_blocks_per_seq,) int32 row for the jitted step; unallocated
        logical blocks point at the null block."""
        row = np.full((self.max_blocks_per_seq,), NULL_BLOCK, np.int32)
        table = self._seqs[seq_id].table
        row[:len(table)] = table
        return row

    def utilization(self) -> float:
        """Fraction of non-null pool blocks currently allocated (cached
        prefix blocks count: they hold live KV)."""
        total = self.allocator.num_blocks - 1
        return (total - self.allocator.num_free) / max(total, 1)
