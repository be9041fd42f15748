"""Autoregressive LM serving engines of the port.

The counterpart of ``repro/serving/engine.py``:

  * :class:`PagedDecodeEngine` — continuous batching over a paged KV pool
    with the reference's defaults: the ragged flat-token batch, the
    segment-tiled attention read (the Hopper kernel on CUDA tensors),
    n-gram speculative decode, the prefix cache with copy-on-write, the
    host swap tier, int8 pools, cancellation, clocks and ``stats()``; and
    the reference's two baselines, the per-token attention read
    (``tiled=False``) and the rectangular (lanes, chunk) batch
    (``ragged=False``), each through its own Hopper kernel.
  * :class:`SlotDecodeEngine` — the dense per-lane oracle over
    ``decode_step``, and the serving path of the recurrent families.
  * :class:`ShardedDecodeEngine` — the data-parallel front: one paged
    engine per data slice of a mesh, requests routed to the least-loaded
    slice.
  * :func:`DecodeEngine` — the facade picking between them.

With ``mesh=`` (``repro_torch.launch.mesh``) one paged engine runs
tensor-parallel over the mesh's "model" positions from one controller:
each position holds its shard of the parameters
(``launch.sharding.serving_param_specs``) and its own KV pools, cut over
the kv heads, and runs every layer at its sharded shapes, the paged read
included (the Hopper kernel per shard on the card); the layers' partial
sums meet in reduces on position 0's device (``transformer.TPPlan``).
Scheduler, block manager, CoW, speculation and transfer address logical
block ids, the same on every position.

The host side (scheduler, block manager, proposer, batch builders) is the
reference's numpy code, copied.  The device side runs eagerly: the KV
pools are updated in place (the reference donates them to a jitted step),
CoW copies are one gather-scatter per pool leaf, and each step reads back
its greedy tokens with a single device-to-host copy.

KV transfer and prefix-cache persistence (``export_kv_prefix``,
``import_kv_shipment``, ``save_prefix_cache``, ``load_prefix_cache``) speak
the reference's wire format (``serving/transfer.py``).  A block's payload
takes the reference's pool layout: the port keeps every layer in one
``"scan"`` pool, and an MoE config's dense first layers (the reference's
``"head"`` pools) are split off it on the way out and merged back on the
way in, so shipments and snapshots cross between the packages.
"""
from __future__ import annotations

import contextlib
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import common
from repro_torch.serving.batch import RaggedBatch, padded_pow2
from repro_torch.serving.blocks import KVCacheManager
from repro_torch.serving.scheduler import (Request, RequestState, Scheduler,
                                           SchedulerConfig, StepDecision)
from repro_torch.serving.spec import NgramProposer, Proposer
from repro_torch.serving.tracing import TimedProposer, Tracer
from repro_torch.serving.transfer import (KVBlockRecord, KVShipment,
                                          TransferIntegrityError,
                                          payload_checksum)


def _emit_token(engine, req: "Request", tok: int) -> bool:
    """The shared step-completion emission: append the token, stamp the
    latency marks from the engine's clock, fire ``on_token``.  Returns
    True when the request just finished (max new tokens or EOS)."""
    req.generated.append(tok)
    req.feed.append(tok)
    engine.tokens_decoded += 1
    if req.t_first_token == 0.0:
        req.t_first_token = engine._now()
    finished = (len(req.generated) >= req.max_new_tokens
                or tok == engine.eos)
    if finished:
        req.t_done = engine._now()
    if engine.on_token is not None:
        with engine.trace.span("on_token"):
            engine.on_token(req.request_id, tok, finished)
    return finished


def _mesh_dp_tp(mesh) -> Tuple[int, int]:
    """(data-parallel degree, tensor-parallel degree) of a serving mesh:
    tp is the "model" axis, dp the product of everything else."""
    from repro_torch.launch.mesh import mesh_axis_sizes
    sizes = mesh_axis_sizes(mesh)
    tp = sizes.get("model", 1)
    dp = 1
    for name, n in sizes.items():
        if name != "model":
            dp *= n
    return dp, tp


def _weight(params) -> Optional[torch.Tensor]:
    """The first weight of a parameter tree of any model family that
    takes the compute dtype (norms, the float32 keys and the router keep
    their own), whose device and dtype the engines take."""
    items = params.items() if isinstance(params, dict) else \
        enumerate(params)
    for key, node in items:
        if isinstance(key, str) and (common.keeps_float32(key) or
                                     key in common.STORED_PRECISION_KEYS):
            continue
        if isinstance(node, (dict, list)):
            leaf = _weight(node)
            if leaf is not None:
                return leaf
        elif node.is_floating_point():
            return node
    return None


def DecodeEngine(model_api, params, *, paged: Optional[bool] = None,
                 mesh=None, **kw):
    """Facade: the paged engine when the model family supports it, the
    dense-slot engine otherwise.  ``paged=True/False`` forces the choice.

    ``mesh`` serves across its positions: the "model" axis shards one
    engine tensor-parallel, and a data axis > 1 routes to
    :class:`ShardedDecodeEngine`, one paged engine per data slice.  Mesh
    serving requires the paged path."""
    if paged is None:
        paged = getattr(model_api, "supports_paged", False)
    if mesh is not None:
        if not paged:
            raise ValueError(
                f"{model_api.cfg.family} models have no paged-KV decode "
                "path; mesh serving shards the paged engine only")
        dp, _ = _mesh_dp_tp(mesh)
        if dp > 1:
            return ShardedDecodeEngine(model_api, params, mesh=mesh, **kw)
        return PagedDecodeEngine(model_api, params, mesh=mesh, **kw)
    cls = PagedDecodeEngine if paged else SlotDecodeEngine
    return cls(model_api, params, **kw)


# ---------------------------------------------------------------------------
class PagedDecodeEngine:
    """Continuous-batching decode over a block-paged KV pool.

    ``n_slots`` lanes share one physical pool; ``cache_len`` caps one
    request's KV length, and ``num_blocks`` defaults to the dense
    equivalent (``n_slots`` full sequences plus the null block).  By
    default every step flattens its scheduled tokens into one stream
    (``RaggedBatch``), cuts it into segment tiles (``TileMap``) and runs
    the ragged step; ``tiled=False`` runs the same stream through the
    per-token attention read, and ``ragged=False`` pads every lane to the
    widest chunk and runs the rectangular paged step.  Both run as
    ``model_api.tp_ragged_step`` / ``tp_paged_step`` over a plan of one
    position, or of the mesh's positions.
    Speculative drafts ride as ``1 + k`` token segments and are verified
    by the step's own per-row argmax.  Greedy outputs do not depend on
    the schedule or the layout, so the engine is token-identical to
    :class:`SlotDecodeEngine` under prefix sharing, preemption, swap and
    cancellation.

    ``device`` defaults to ``"cuda"``; the parameters must already live
    there.  ``cache_dtype`` defaults to the parameters' dtype
    (``torch.int8`` stores quantized pools with per-(block, slot, head)
    scales).  ``compute_dtype`` is the parameters' dtype: the port casts
    weights once, so passing another one raises.

    ``mesh`` (a ``repro_torch.launch.mesh.Mesh`` whose data axes are size
    1) runs the engine tensor-parallel over its "model" positions, which
    then place everything (``device`` is not read; the parameters may
    live anywhere): each position gets a contiguous shard of every
    parameter that ``serving_param_specs`` cuts (replicated ones are
    shared where the position sits on their device), pools holding the
    kv heads its attention reads, and each step's metadata once per
    distinct device.  Logits and greedy tokens are read on position 0's
    device (``self.device``).
    """

    def __init__(self, model_api, params, *, n_slots: int, cache_len: int,
                 eos_token: int = -1, window: int = 0,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 token_budget: int = 0, chunk_tokens: int = 16,
                 prefix_cache: bool = True, ragged: Optional[bool] = None,
                 tiled: Optional[bool] = None, tile: int = 16,
                 spec: bool = True, draft_k: int = 4,
                 proposer: Optional[Proposer] = None,
                 host_swap: bool = True,
                 host_swap_blocks: Optional[int] = None,
                 ttft_target: float = 0.0, tpot_target: float = 0.0,
                 clock=None, mesh=None, cache_dtype=None,
                 compute_dtype=None, device="cuda") -> None:
        """Build the paged engine: block pool, scheduler, device pools."""
        if not getattr(model_api, "supports_paged", False):
            raise ValueError(
                f"{model_api.cfg.family} models have no paged-KV decode "
                "path; use DecodeEngine (it falls back to dense slots)")
        self.api = model_api
        self.params = params
        self.mesh = mesh
        self.tp = 1
        emb = _weight(params)
        if mesh is None:
            self.device = resolve_device(device)
            if emb.device != self.device:
                raise ValueError(f"parameters live on {emb.device}, the "
                                 f"engine runs on {self.device}")
            self._positions = [self.device]
        else:
            dp, self.tp = _mesh_dp_tp(mesh)
            if dp > 1:
                raise ValueError(
                    f"mesh has a data-parallel extent of {dp}; "
                    "PagedDecodeEngine shards ONE engine tensor-parallel — "
                    "use ShardedDecodeEngine (or DecodeEngine(mesh=...)) "
                    "for data-parallel slices")
            self._positions = [resolve_device(d)
                               for d in mesh.devices.reshape(-1)]
            self.device = self._positions[0]
        if compute_dtype is not None and compute_dtype != emb.dtype:
            raise ValueError(f"compute_dtype {compute_dtype} differs from the "
                             f"parameters' {emb.dtype}; make or convert the "
                             "parameters in the compute dtype")
        self.n_slots = n_slots
        self.cache_len = cache_len
        self.eos = eos_token
        self.window = window
        self.block_size = block_size
        if chunk_tokens < 1:
            raise ValueError("chunk_tokens must be >= 1 "
                             "(1 = one-token-per-step prefill)")
        # the flat-token batch is the default where the family has the
        # flat step; ragged=False pins the rectangular (lanes, chunk) batch
        ragged_fn = getattr(model_api, "ragged_step", None)
        if ragged is None:
            ragged = ragged_fn is not None
        if ragged and ragged_fn is None:
            raise ValueError(
                f"{model_api.cfg.family} models have no ragged_step; "
                "pass ragged=False for the rectangular paged path")
        self.ragged = ragged
        # the segment-tiled read is the flat batch's default; tiled=False
        # pins the per-token read
        if tiled is None:
            tiled = ragged
        if tiled and not ragged:
            raise ValueError("tiled=True requires the ragged flat-token "
                             "layout (pass ragged=True)")
        if tile < 1 or tile & (tile - 1):
            raise ValueError(f"tile must be a positive power of two, "
                             f"got {tile}")
        self.tiled = tiled
        self.tile = tile
        self.chunk_tokens = chunk_tokens
        if draft_k < 0:
            raise ValueError(f"draft_k must be >= 0, got {draft_k}")
        self.spec = bool(spec) and draft_k > 0
        self.draft_k = draft_k if self.spec else 0
        if self.spec and proposer is None:
            proposer = NgramProposer()
        self.proposer = proposer if self.spec else None
        self.max_blocks = -(-cache_len // block_size)
        if num_blocks is None:
            num_blocks = n_slots * self.max_blocks + 1   # +1: null block
        self.num_blocks = num_blocks
        self.kv = KVCacheManager(num_blocks, block_size,
                                 max_blocks_per_seq=self.max_blocks,
                                 enable_prefix_cache=prefix_cache)
        # device->host swap tier: digest -> {"parent", "tokens", "payload"},
        # LRU-ordered; payloads are CPU tensors (numpy has no bfloat16)
        self.host_swap = bool(host_swap) and prefix_cache
        self.host_swap_blocks = host_swap_blocks
        self._host_tier: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self.host_swap_outs = 0
        self.host_swap_ins = 0
        self.host_swap_drops = 0
        # digests mid-import whose payload write has not landed yet: the
        # swap-out hook must not capture their unwritten device bytes
        self._swap_quarantine: set = set()
        if self.host_swap:
            self.kv.host_has = self._host_tier.__contains__
            self.kv.on_swap_out = self._swap_out_block
        # spans and counters of the step (serving/tracing.py)
        self.trace = Tracer()
        self.scheduler = Scheduler(
            SchedulerConfig(n_lanes=n_slots, token_budget=token_budget,
                            chunk_tokens=self.chunk_tokens,
                            fill_to_bucket=self.ragged,
                            draft_k=self.draft_k,
                            proposer=(TimedProposer(self.proposer,
                                                    self.trace)
                                      if self.spec else None),
                            ttft_target=ttft_target,
                            tpot_target=tpot_target),
            self.kv)
        self.clock = None
        self.set_clock(clock)
        self.on_token = None
        # the reference keeps an MoE config's dense first layers in their
        # own "head" pools; the port's pool holds them as layers 0..n-1
        moe_cfg = getattr(model_api.cfg, "moe", None)
        self._n_head = moe_cfg.first_dense_layers if moe_cfg else 0
        # the MoE stages are timed with CUDA events while the log is on
        self._moe_events = moe_cfg is not None and \
            self.device.type == "cuda"
        pool_kw = dict(num_blocks=num_blocks, block_size=block_size,
                       max_blocks_per_lane=self.max_blocks,
                       dtype=cache_dtype if cache_dtype is not None
                       else emb.dtype)
        self._collectives_per_step = 0
        self.collective_ops = 0
        # one step for both: off a mesh, the one-position plan over the
        # whole parameters
        if mesh is None:
            self._plan = model_api.tp_plan(None, self._positions)
            self._shards = [params]
        else:
            from repro_torch.launch import sharding as shlib
            from repro_torch.launch.mesh import mesh_axis_sizes
            specs = shlib.serving_param_specs(params, mesh_axis_sizes(mesh))
            self._plan = model_api.tp_plan(specs, self._positions)
            self._shards = shlib.shard_tree(params, self._plan.specs, mesh)
        self._kv_ranges = self._plan.kv
        self._caches = [model_api.init_paged_cache(
            n_slots, device=dev, n_kv_heads=k1 - k0, **pool_kw)
            for dev, (k0, k1) in zip(self._positions, self._kv_ranges)]
        self._step_fn = (model_api.tp_ragged_step if self.ragged
                         else model_api.tp_paged_step)
        # the positions whose pools cover the kv heads in order: a block
        # payload is gathered from them along the kv heads
        self._kv_sources: List[int] = []
        covered = 0
        for s, (k0, k1) in enumerate(self._kv_ranges):
            if k0 == covered:
                self._kv_sources.append(s)
                covered = k1
        self.kv_heads_sharded = len(self._kv_sources) > 1
        self.cache = self._caches[0]
        self._step_kw = {"window": window}
        if self.tiled:
            self._step_kw["tile"] = tile
        self._finished: List[Request] = []
        self._next_id = 0
        self.tokens_decoded = 0
        self.tokens_prefilled = 0
        self.cancelled = 0
        self.shed = 0
        self.host_purged = 0
        self.cow_block_copies = 0
        self.steps = 0
        self.scheduled_tokens = 0
        self.padded_tokens = 0
        self.tokens_drafted = 0
        self.draft_tokens_accepted = 0
        self.spec_verifications = 0
        self.spec_tokens_emitted = 0

    # ------------------------------------------------------------------
    def _put(self, x: np.ndarray) -> List[torch.Tensor]:
        """A host-built int32 array on every position's device (one copy
        per distinct device), in position order."""
        host = torch.from_numpy(np.ascontiguousarray(x, np.int32))
        per: Dict[torch.device, torch.Tensor] = {}
        for dev in self._positions:
            if dev not in per:
                per[dev] = host.to(dev)
        return [per[dev] for dev in self._positions]

    def _set_meta(self, name: str, x: np.ndarray) -> None:
        """Put step metadata ``name`` into every position's cache."""
        for cache, t in zip(self._caches, self._put(x)):
            cache[name] = t

    def _run_step(self, tokens: List[torch.Tensor]) -> torch.Tensor:
        """The model step on the scheduled tokens (``_put`` already);
        logits on ``self.device``.  Counts the step's collectives (none
        off a mesh)."""
        with self.trace.span("launch"):
            self._plan.reset()
            self._plan.stages = (self.trace.moe if self._moe_events
                                 and self.trace.logging else None)
            logits, _ = self._step_fn(self._shards, self._caches, tokens,
                                      self._plan, **self._step_kw)
        self._collectives_per_step = self._plan.collectives
        self.collective_ops += self._plan.collectives
        return logits

    def set_clock(self, clock) -> None:
        """Install a virtual clock (any object with ``.now``) as the source
        of every latency stamp; ``None`` restores wall time."""
        self.clock = clock
        self.scheduler.now_fn = self._now

    def _now(self) -> float:
        return self.clock.now if self.clock is not None \
            else time.perf_counter()

    def submit(self, prompt: np.ndarray, max_new_tokens: int,
               priority: int = 0) -> int:
        """Queue a request; returns its id.  Rejects requests whose total
        length can never fit the pool."""
        prompt = np.asarray(prompt, np.int32)
        total = len(prompt) + max_new_tokens
        usable = min(self.max_blocks, self.num_blocks - 1)
        if self.kv.blocks_needed(total) > usable:
            raise ValueError(
                f"request of {total} tokens needs "
                f"{self.kv.blocks_needed(total)} blocks; engine can serve "
                f"at most {usable} per request")
        rid = self._next_id
        self._next_id += 1
        req = Request(rid, prompt, max_new_tokens, priority=priority)
        req.t_submit = self._now()
        self.scheduler.add(req)
        return rid

    def cancel(self, request_id: int) -> bool:
        """Abort a queued or mid-flight request between steps, freeing its
        lane, its KV blocks, the prefix-cache registrations no other live
        sequence shares and their host-tier payloads.  Returns False when
        the id is unknown or already finished."""
        req = next((r for r in self.scheduler.running
                    if r.request_id == request_id), None)
        if req is None:
            req = next((r for r in self.scheduler.waiting
                        if r.request_id == request_id), None)
        if req is None:
            return False
        feed = req.feed if req.state is RequestState.RUNNING and req.feed \
            else [int(t) for t in req.prompt] + list(req.generated)
        self.scheduler.abort(req)
        purge: List[str] = []
        if self.kv.has_seq(request_id):
            purge += self.kv.release_seq(request_id)
        purge += self.kv.release_chain(feed)
        for d in purge:
            if self._host_tier.pop(d, None) is not None:
                self.host_purged += 1
        req.t_done = self._now()
        self._finished.append(req)
        self.cancelled += 1
        return True

    # ------------------------------------------------------------------
    def _apply_copies(self, copies: List[Tuple[int, int]]) -> None:
        """Copy-on-write: pool[:, dst] = pool[:, src] for every pool leaf
        (K, V and int8 scale planes) of every position.  The gather on the
        right makes a copy, so overlapping src and dst are safe."""
        pairs = self._put(np.asarray(copies, np.int32).T)
        for cache, (src, dst) in zip(self._caches, pairs):
            for arr in cache["scan"].values():
                arr[:, dst.long()] = arr[:, src.long()]

    def _gather_greedy(self, decision: StepDecision,
                       flat_logits: torch.Tensor, seg_start):
        """Argmax only the rows that can emit: for each scheduled request,
        rows ``base-1 .. n-1`` of its segment (a draft segment's
        verification window, else its last row), with one readback.
        ``seg_start(req)`` is the segment's first row of ``flat_logits``.
        Returns ``greedy(req, j)``, the argmax at row ``j`` of the
        segment.  The readback has passed the step's MoE stage events:
        their times are read here."""
        with self.trace.span("readback"):
            offsets: Dict[int, int] = {}
            rows: List[int] = []
            for r in decision.scheduled:
                n = decision.num_scheduled[r.request_id]
                first = n - 1 - len(decision.drafts.get(r.request_id, ()))
                offsets[r.request_id] = len(rows) - first
                start = seg_start(r)
                rows.extend(range(start + first, start + n))
            if rows:
                idx = torch.tensor(rows, device=self.device)
                toks = torch.argmax(flat_logits[idx], dim=-1).cpu().numpy()
            self.trace.moe.collect()
        if not rows:
            return lambda r, j: 0
        return lambda r, j: int(toks[offsets[r.request_id] + j])

    def _run_rect(self, decision: StepDecision):
        """The rectangular (n_slots, chunk_width) step: every lane padded
        to the widest scheduled chunk (pow2).  Paused lanes keep
        ``q_lens = 0``: their writes go to the null block and their rows
        are never read.  Returns ``greedy(req, j)``."""
        with self.trace.span("prepare"):
            sched_ids = {r.request_id for r in decision.scheduled}
            width = padded_pow2(max(
                [decision.num_scheduled[r.request_id]
                 for r in decision.scheduled] or [1]))
            tokens = np.zeros((self.n_slots, width), np.int32)
            pos = np.zeros((self.n_slots,), np.int32)
            q_lens = np.zeros((self.n_slots,), np.int32)
            tables = np.zeros((self.n_slots, self.max_blocks), np.int32)
            for r in self.scheduler.running:
                pos[r.lane] = r.cursor
                tables[r.lane] = self.kv.padded_table(r.request_id)
                if r.request_id in sched_ids:
                    n = decision.num_scheduled[r.request_id]
                    q_lens[r.lane] = n
                    tokens[r.lane, :n] = decision.segment_tokens(r)
            self._set_meta("block_tables", tables)
            self._set_meta("pos", pos)
            self._set_meta("q_lens", q_lens)
            fed = self._put(tokens)
        logits = self._run_step(fed)
        self.scheduled_tokens += int(q_lens.sum())
        self.padded_tokens += self.n_slots * width
        return self._gather_greedy(
            decision, logits.reshape(self.n_slots * width, -1),
            lambda r: r.lane * width)

    def _run_ragged(self, decision: StepDecision):
        """The flat-token step: the segment-tiled read through a TileMap,
        or (``tiled=False``) the per-token read through ``token_lane``.
        Returns ``greedy(req, j)``."""
        with self.trace.span("prepare"):
            batch = RaggedBatch.build(decision, self.kv, self.n_slots,
                                      self.block_size,
                                      cap=self.scheduler._budget())
            tables = np.zeros((self.n_slots, self.max_blocks), np.int32)
            for r in self.scheduler.running:
                tables[r.lane] = self.kv.padded_table(r.request_id)
            self._set_meta("block_tables", tables)
            self._set_meta("token_pos", batch.token_pos)
            self._set_meta("slot_mapping", batch.slot_mapping)
            if self.tiled:
                tiles = batch.tiles(self.n_slots, self.tile)
                self._set_meta("tile_meta", tiles.meta)
                self._set_meta("row_tile", tiles.row_tile)
            else:
                self._set_meta("token_lane", batch.token_lane)
            fed = self._put(batch.tokens)
        logits = self._run_step(fed)
        self.scheduled_tokens += batch.total_tokens
        self.padded_tokens += batch.padded_tokens
        return self._gather_greedy(decision, logits,
                                   lambda r: batch.q_starts[r.request_id])

    def step(self) -> StepDecision:
        """One engine iteration: schedule, swap in, apply CoW copies, run
        the ragged or rectangular step, then accept each lane's longest matching draft
        prefix plus one bonus token and rewind the rejected KV slots.
        Each phase is a span of ``self.trace``; the ``step`` span's wall
        time feeds the scheduler's TPOT estimate."""
        tr = self.trace
        tr.begin_step(self.steps)
        with tr.span("step") as whole:
            with tr.span("schedule"):
                decision = self.scheduler.schedule()
            # swap-ins first: a CoW copy may read a block just swapped in
            if self.host_swap:
                with tr.span("swap_in"):
                    swapins = self.kv.take_swap_ins()
                    if swapins:
                        self._apply_swap_ins(swapins)
                    if self.host_swap_blocks is not None:
                        while len(self._host_tier) > self.host_swap_blocks:
                            self._host_tier.popitem(last=False)
                            self.host_swap_drops += 1
            with tr.span("cow"):
                copies = self.kv.take_copy_ops()
                if copies:
                    self._apply_copies(copies)
                    self.cow_block_copies += len(copies)
            greedy = (self._run_ragged(decision) if self.ragged
                      else self._run_rect(decision))
            self.steps += 1
            with tr.span("verify"):
                emitted = self._accept(decision, greedy)
        self.scheduler.observe_step(whole.ns * 1e-9, emitted)
        return decision

    def _accept(self, decision: StepDecision, greedy) -> int:
        """Accept each scheduled lane's longest matching draft prefix plus
        one bonus token, emit them, rewind the rejected KV slots, finish
        and shed; returns the tokens emitted."""
        emitted = 0
        for r in list(decision.scheduled):
            n = decision.num_scheduled[r.request_id]
            drafts = decision.drafts.get(r.request_id, [])
            base = n - len(drafts)              # fed (non-draft) tokens
            emitting = r.cursor + base == len(r.feed)
            if not emitting:
                r.cursor += n                   # mid-prompt prefill chunk
                self.tokens_prefilled += n
                continue
            self.tokens_prefilled += base - 1
            m = 0
            while m < len(drafts) and greedy(r, base - 1 + m) == drafts[m]:
                m += 1
            new_toks = [int(t) for t in drafts[:m]] + [greedy(r, base - 1 + m)]
            if drafts:
                self.tokens_drafted += len(drafts)
                self.draft_tokens_accepted += m
                self.spec_verifications += 1
            kept = 0
            finished = False
            for tok in new_toks:
                kept += 1
                finished = _emit_token(self, r, tok)
                if finished:
                    break
            emitted += kept
            if drafts:
                self.spec_tokens_emitted += kept
            r.cursor += base + min(kept, m)
            if finished:
                self.scheduler.finish(r)
                self._finished.append(r)
            elif len(drafts) > m:
                self.kv.rewind(r.request_id, r.cursor)
        shed = self.scheduler.take_shed()
        if shed:
            self._finished.extend(shed)
            self.shed += len(shed)
        return emitted

    def has_work(self) -> bool:
        """True while requests are queued or running."""
        return self.scheduler.has_work()

    def run_until_drained(self, max_steps: int = 100_000) -> List[Request]:
        """Step until no work remains; returns the requests finished since
        the last call."""
        for _ in range(max_steps):
            if not self.scheduler.has_work():
                break
            decision = self.step()
            if not decision.scheduled and self.scheduler.waiting:
                raise RuntimeError(
                    "serving stalled: waiting requests cannot be admitted "
                    f"({self.kv.num_free_blocks} free blocks)")
        return self.take_finished()

    def take_finished(self) -> List[Request]:
        """Hand off (and clear) the requests finished since the last call."""
        out, self._finished = self._finished, []
        return out

    # ------------------------------------------------------------------
    # device->host swap tier
    # ------------------------------------------------------------------
    def _read_block_payload(self, blk: int) -> Dict:
        """One physical block's slice of every pool leaf, copied into CPU
        tensors in the reference's pool layout (``part -> {"k", "v",
        ...}``, each (layers, bs, Hkv[, D])): ``"scan"``, and ``"head"``
        for the dense first layers of an MoE config.  On a mesh the kv
        heads are gathered from the positions that hold them, so the
        payload does not depend on the sharding."""
        def part(name: str, layers: slice) -> torch.Tensor:
            got = [self._caches[s]["scan"][name][layers, blk].to(
                "cpu", copy=True) for s in self._kv_sources]
            return got[0] if len(got) == 1 else torch.cat(got, dim=2)

        names = list(self.cache["scan"])
        out = {"scan": {n: part(n, slice(self._n_head, None))
                        for n in names}}
        if self._n_head:
            out["head"] = {n: part(n, slice(0, self._n_head)) for n in names}
        return out

    def _write_block_payloads(self, blocks: List[int],
                              payloads: List[Dict]) -> None:
        """Scatter host block payloads (the reference's pool layout, as
        ``_read_block_payload`` gives it) into the device pools at
        ``blocks`` (block axis 1 of every pool leaf)."""
        pools = self.cache["scan"]
        n_layers = pools["k"].shape[0]
        parts = ("head", "scan") if self._n_head else ("scan",)
        for part in parts:
            for p in payloads:
                if part not in p or set(p[part]) != set(pools):
                    raise ValueError(
                        f"payload pool-name mismatch on '{part}': got "
                        f"{sorted(p.get(part, {}))}, engine pools are "
                        f"{sorted(pools)} (fp and int8 pools do not mix)")
        idx = self._put(np.asarray(blocks, np.int32))
        hkv = self.api.cfg.n_kv_heads
        for name, arr in pools.items():
            rows = []
            for p in payloads:
                got = [p[part][name] for part in parts]
                for part, t in zip(parts, got):
                    n = self._n_head if part == "head" \
                        else n_layers - self._n_head
                    want = (n, arr.shape[2], hkv) + tuple(arr.shape[4:])
                    if tuple(t.shape) != want:
                        raise ValueError(
                            f"payload KV geometry mismatch on "
                            f"'{part}/{name}': got {tuple(t.shape)}, "
                            f"engine pool expects {want}")
                rows.append(got[0] if len(got) == 1 else torch.cat(got))
            stack = torch.stack(rows, dim=1)    # (L, n, bs, Hkv[, D])
            for cache, (k0, k1), blk in zip(self._caches, self._kv_ranges,
                                            idx):
                dst = cache["scan"][name]
                dst[:, blk.long()] = stack[:, :, :, k0:k1].to(
                    device=dst.device, dtype=dst.dtype)

    def _swap_out_block(self, digest: str, blk: int, parent: str,
                        tokens) -> None:
        """Eviction hook: park an evicted registered block's payload in
        the host tier (skipping digests it already holds: full blocks are
        immutable once registered; and digests mid-import, whose payload
        write is still pending)."""
        if digest in self._host_tier:
            self._host_tier.move_to_end(digest)
            return
        if digest in self._swap_quarantine:
            return
        with self.trace.span("swap_out"):
            self._host_tier[digest] = {
                "parent": parent, "tokens": tuple(int(t) for t in tokens),
                "payload": self._read_block_payload(blk)}
        self.host_swap_outs += 1

    def _apply_swap_ins(self, ops: List[Tuple[str, int]]) -> None:
        """Write queued host->device swap-ins into the pools; an op whose
        target block was re-registered since planning is dropped."""
        blocks: List[int] = []
        payloads: List[Dict] = []
        for digest, blk in ops:
            if self.kv.digest_block(digest) != blk:
                continue
            ent = self._host_tier.get(digest)
            if ent is None:
                raise RuntimeError(
                    f"swap-in payload for block digest {digest[:12]} "
                    "missing from the host tier")
            self._host_tier.move_to_end(digest)
            blocks.append(blk)
            payloads.append(ent["payload"])
        if not blocks:
            return
        self._write_block_payloads(blocks, payloads)
        self.host_swap_ins += len(blocks)

    # ------------------------------------------------------------------
    # KV transfer / persistence (see repro_torch.serving.transfer)
    # ------------------------------------------------------------------
    def cached_digests(self) -> frozenset:
        """Chain digests of every full block the prefix cache holds — the
        receiver-side set a sender dedups shipments against."""
        return self.kv.cached_digests()

    def _records(self, chain) -> List:
        """``KVBlockRecord``s of ``(digest, parent, block, tokens)``
        tuples, each with its pool payload and checksum."""
        out = []
        for digest, parent, blk, tokens in chain:
            payload = self._read_block_payload(blk)
            out.append(KVBlockRecord(
                digest=digest, parent=parent, tokens=tokens,
                payload=payload, checksum=payload_checksum(payload)))
        return out

    def export_kv_prefix(self, feed: np.ndarray):
        """Package the cached KV prefix of ``feed`` as a
        :class:`~repro_torch.serving.transfer.KVShipment`.

        Exports the longest chain of cached full blocks covering the
        feed's prefix — each with its KV payload (CPU tensors) and
        checksum — plus the remaining tokens as the payload-free partial
        tail.  The usual source is a just-prefilled prompt (every full
        block was registered as prefill completed it, and registrations
        survive the sequence's ``free`` via the cache's own hold).
        """
        chain = self.kv.export_chain(feed)
        covered = len(chain) * self.block_size
        return KVShipment(block_size=self.block_size,
                          blocks=self._records(chain),
                          partial_tokens=[int(t) for t in feed[covered:]])

    def import_kv_shipment(self, shipment) -> Dict[str, int]:
        """Attach a (verified) shipment's blocks to this engine's cache.

        Each block is registered with the prefix cache under its chain
        digest and its payload written into the device KV pools (one
        batched write), so the next ``submit`` of the matching prompt
        attaches the chain as an ordinary prefix hit.  Blocks already
        cached are skipped (the dedup contract: a stripped payload must be
        one of these — anything else raises
        :class:`~repro_torch.serving.transfer.TransferIntegrityError`).
        Imported blocks are immediately evictable; when the pool has no
        room the rest of the chain is dropped (counted, not fatal — the
        decode side recomputes more).  Returns ``{"imported",
        "dedup_skipped", "dropped_no_space", "tokens_attachable"}``.
        """
        if shipment.block_size != self.block_size:
            raise ValueError(
                f"shipment block_size {shipment.block_size} != engine "
                f"block_size {self.block_size}")
        imported: List[Tuple[str, int]] = []
        payloads: List[Dict] = []
        skipped = dropped = 0
        try:
            for rec in shipment.blocks:
                if self.kv.has_digest(rec.digest):
                    skipped += 1
                    continue
                if rec.payload is None:
                    raise TransferIntegrityError(
                        f"block {rec.digest[:12]} arrived without a payload "
                        "but is not in this engine's cache — dedup stripped "
                        "a block the receiver does not hold")
                self._swap_quarantine.add(rec.digest)
                try:
                    blk = self.kv.import_block(rec.parent, rec.tokens,
                                               digest=rec.digest)
                except RuntimeError:
                    # pool full of live sequences: drop the chain's tail
                    dropped = sum(1 for b in shipment.blocks
                                  if not self.kv.has_digest(b.digest))
                    break
                if blk is not None:
                    imported.append((rec.digest, blk))
                    payloads.append(rec.payload)
            # importing can itself evict an earlier import of this very
            # shipment (and recycle its block): write only payloads whose
            # registration survived, into their still-registered blocks
            live = [(b, p) for (d, b), p in zip(imported, payloads)
                    if self.kv.digest_block(d) == b]
            if live:
                self._write_block_payloads([b for b, _ in live],
                                           [p for _, p in live])
        finally:
            for rec in shipment.blocks:
                self._swap_quarantine.discard(rec.digest)
        return {"imported": len(imported), "dedup_skipped": skipped,
                "dropped_no_space": dropped,
                "tokens_attachable": (len(imported) + skipped)
                * self.block_size}

    def save_prefix_cache(self, path: str) -> int:
        """Persist every cached full block to ``path`` in the wire format
        and return the bytes written; a restarted engine (of either
        package) reloads it with ``load_prefix_cache``."""
        data = KVShipment(block_size=self.block_size,
                          blocks=self._records(self.kv.export_all_cached()),
                          partial_tokens=[]).serialize()
        with open(path, "wb") as f:
            f.write(data)
        return len(data)

    def load_prefix_cache(self, path: str) -> Dict[str, int]:
        """Restore a ``save_prefix_cache`` snapshot (verifying every
        checksum and chain digest) into this engine's prefix cache.
        Returns the :meth:`import_kv_shipment` stats."""
        with open(path, "rb") as f:
            data = f.read()
        return self.import_kv_shipment(KVShipment.deserialize(data))

    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        """Counters: token throughput, padding efficiency, prefix cache,
        speculation, swap tier and cancellation (the reference's keys);
        then admissions and their queue wait, and the step's spans
        (``Tracer.stats``)."""
        return {
            "steps": self.steps,
            "tokens_decoded": self.tokens_decoded,
            "tokens_prefilled": self.tokens_prefilled,
            "active": len(self.scheduler.running),
            "waiting": len(self.scheduler.waiting),
            "preemptions": self.scheduler.total_preemptions,
            "block_utilization": self.kv.utilization(),
            "prefix_hits": self.kv.prefix_hits,
            "prefix_tokens_reused": self.kv.prefix_tokens_reused,
            "cow_copies": self.kv.cow_copies,
            "cache_evictions": self.kv.evictions,
            "ragged": int(self.ragged),
            "tiled": int(self.tiled),
            "padding_efficiency": (self.scheduled_tokens
                                   / max(self.padded_tokens, 1)),
            "spec": int(self.spec),
            "kv_rewinds": self.kv.rewinds,
            "kv_tokens_rewound": self.kv.tokens_rewound,
            "tokens_drafted": self.tokens_drafted,
            "draft_tokens_accepted": self.draft_tokens_accepted,
            "spec_verifications": self.spec_verifications,
            "accepted_per_spec_step": (self.spec_tokens_emitted
                                       / max(self.spec_verifications, 1)),
            "draft_acceptance_rate": (self.draft_tokens_accepted
                                      / max(self.tokens_drafted, 1)),
            "host_swap": int(self.host_swap),
            "swap_outs": self.host_swap_outs,
            "swap_ins": self.host_swap_ins,
            "swapped_in_tokens": self.kv.swapped_in_tokens,
            "host_tier_blocks": len(self._host_tier),
            "host_swap_drops": self.host_swap_drops,
            "preempt_swap_outs": self.scheduler.total_swap_outs,
            "cancelled": self.cancelled,
            "shed": self.shed,
            "released_seqs": self.kv.released_seqs,
            "swap_ins_dropped": self.kv.swap_ins_dropped,
            "host_purged": self.host_purged,
            # mesh / tensor-parallel accounting (tp=1, zeros off-mesh):
            # the reduces and gathers of one step, and their running total
            "tp": self.tp,
            "kv_heads_sharded": int(self.kv_heads_sharded),
            "collectives_per_step": self._collectives_per_step,
            "collective_ops": self.collective_ops,
            # first admissions and their summed wait since submit
            "admitted": self.scheduler.first_admissions,
            "queue_wait_s": self.scheduler.queue_wait_s,
            # the step's spans (serving/tracing.py)
            **self.trace.stats(),
        }


# ---------------------------------------------------------------------------
def _step_on_thread(eng: PagedDecodeEngine) -> None:
    """Step a slice from a pool thread, which must enter grad mode and its
    slice's current CUDA device itself: both are per thread."""
    dev = eng.device
    with torch.no_grad(), (torch.cuda.device(dev) if dev.type == "cuda"
                           else contextlib.nullcontext()):
        eng.step()


class ShardedDecodeEngine:
    """Data-parallel serving front: one full paged engine per mesh slice.

    The mesh's data axes are cut into ``dp`` slices of ``tp`` positions
    (:func:`repro_torch.launch.mesh.mesh_slices`); each slice runs a
    complete :class:`PagedDecodeEngine` (scheduler, block pool, prefix
    cache, CoW, speculation, transfer) tensor-parallel over its own
    "model" axis.  Requests go to the least-loaded slice by outstanding
    tokens (lowest index breaks ties), so arrivals never queue on one
    slice while another idles; greedy decode per request does not depend
    on the schedule, so a dense model's fleet output equals one engine's.
    Slices share no device state; with more than one slice their steps
    run on a thread pool.

    ``n_slots`` (and the pool size derived from it) is per slice: the
    front scales capacity with the mesh instead of splitting a budget.
    """

    def __init__(self, model_api, params, *, mesh=None, **engine_kw) -> None:
        """Split ``mesh`` (default: every visible CUDA card, pure data
        parallel) into slices and build one :class:`PagedDecodeEngine`
        per slice; ``engine_kw`` goes to every slice unchanged."""
        from repro_torch.launch.mesh import make_host_mesh, mesh_slices
        if mesh is None:
            mesh = make_host_mesh()
        self.mesh = mesh
        self.engines = [PagedDecodeEngine(model_api, params, mesh=m,
                                          **engine_kw)
                        for m in mesh_slices(mesh)]
        self.api = model_api
        self.device = self.engines[0].device
        self.n_slices = len(self.engines)
        # global request id -> (slice index, slice-local id); finished
        # requests are handed back under their global id
        self._route: Dict[int, tuple] = {}
        self._gid_of: Dict[tuple, int] = {}
        self._next_id = 0
        self._finished: List[Request] = []
        self._on_token = None
        self.clock = None
        self._pool = (ThreadPoolExecutor(max_workers=self.n_slices)
                      if self.n_slices > 1 else None)

    # ------------------------------------------------------------------
    @staticmethod
    def _outstanding(eng: PagedDecodeEngine) -> int:
        """Tokens a slice still owes: remaining feed plus unemitted budget
        of its running requests, and the full prompt + budget of queued
        ones."""
        sched = eng.scheduler
        load = 0
        for r in sched.running:
            load += (r.remaining_feed
                     + (r.max_new_tokens - len(r.generated)))
        for r in sched.waiting:
            load += (len(r.prompt) + len(r.generated)
                     + (r.max_new_tokens - len(r.generated)))
        return load

    def submit(self, prompt: np.ndarray, max_new_tokens: int,
               priority: int = 0) -> int:
        """Queue a request on the least-loaded slice; returns its global
        id."""
        gid = self._next_id
        i = min(range(self.n_slices),
                key=lambda k: (self._outstanding(self.engines[k]), k))
        local = self.engines[i].submit(prompt, max_new_tokens,
                                       priority=priority)
        self._next_id += 1
        self._route[gid] = (i, local)
        self._gid_of[(i, local)] = gid
        return gid

    def cancel(self, request_id: int) -> bool:
        """Abort a queued or mid-flight request by global id on its slice;
        False if unknown or already finished."""
        loc = self._route.get(request_id)
        if loc is None:
            return False
        i, local = loc
        ok = self.engines[i].cancel(local)
        if ok:
            self._collect()
        return ok

    def set_clock(self, clock) -> None:
        """Install one virtual clock on every slice."""
        self.clock = clock
        for e in self.engines:
            e.set_clock(clock)

    @property
    def on_token(self):
        """Streaming callback ``(global_id, token, finished)``; setting it
        installs per-slice wrappers that rewrite local ids to global."""
        return self._on_token

    @on_token.setter
    def on_token(self, cb) -> None:
        self._on_token = cb
        for i, e in enumerate(self.engines):
            if cb is None:
                e.on_token = None
            else:
                e.on_token = (lambda rid, tok, fin, _i=i:
                              cb(self._gid_of[(_i, rid)], tok, fin))

    def _collect(self) -> None:
        """Move every slice's finished requests into the global list under
        their global ids."""
        for i, eng in enumerate(self.engines):
            done, eng._finished = eng._finished, []
            for r in done:
                r.request_id = self._gid_of[(i, r.request_id)]
                self._finished.append(r)

    def has_work(self) -> bool:
        """True while any slice holds queued or running requests."""
        return any(e.scheduler.has_work() for e in self.engines)

    def step(self) -> None:
        """One iteration of every slice that has work, on the thread pool
        when more than one has."""
        active = [e for e in self.engines if e.scheduler.has_work()]
        if self._pool is not None and len(active) > 1:
            list(self._pool.map(_step_on_thread, active))
        else:
            for e in active:
                e.step()
        self._collect()

    def run_until_drained(self, max_steps: int = 100_000) -> List[Request]:
        """Step all slices until no work remains; returns the requests
        finished since the last call, under global ids."""
        for _ in range(max_steps):
            if not self.has_work():
                break
            self.step()
        return self.take_finished()

    def take_finished(self) -> List[Request]:
        """Hand off (and clear) finished requests under global ids."""
        self._collect()
        out, self._finished = self._finished, []
        return out

    # fleet totals, for callers written against one engine
    @property
    def steps(self) -> int:
        """Most steps of any slice (slices step together)."""
        return max((e.steps for e in self.engines), default=0)

    @property
    def tokens_decoded(self) -> int:
        return sum(e.tokens_decoded for e in self.engines)

    @property
    def tokens_prefilled(self) -> int:
        return sum(e.tokens_prefilled for e in self.engines)

    # ------------------------------------------------------------------
    # KV transfer across the slice set
    # ------------------------------------------------------------------
    def cached_digests(self) -> frozenset:
        """Digests EVERY slice holds: the safe dedup set, since a sender
        may strip only blocks no receiving slice would miss."""
        out = None
        for e in self.engines:
            d = e.cached_digests()
            out = d if out is None else (out & d)
        return out if out is not None else frozenset()

    def export_kv_prefix(self, feed: np.ndarray):
        """Export ``feed``'s cached prefix from the slice covering the
        most of it."""
        best = max(self.engines,
                   key=lambda e: len(e.kv.export_chain(feed)))
        return best.export_kv_prefix(feed)

    def import_kv_shipment(self, shipment) -> Dict[str, int]:
        """Import a shipment into every slice (each has its own pool),
        summing the per-slice stats, so a warmed prefix hits on whichever
        slice serves the prompt."""
        total: Dict[str, int] = {}
        for e in self.engines:
            for k, v in e.import_kv_shipment(shipment).items():
                total[k] = total.get(k, 0) + v
        return total

    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        """Fleet totals plus the per-slice lists that show imbalance."""
        per = [e.stats() for e in self.engines]
        return {
            "slices": self.n_slices,
            "tp": per[0]["tp"] if per else 1,
            "steps": max((p["steps"] for p in per), default=0),
            "tokens_decoded": sum(p["tokens_decoded"] for p in per),
            "tokens_prefilled": sum(p["tokens_prefilled"] for p in per),
            "active": sum(p["active"] for p in per),
            "waiting": sum(p["waiting"] for p in per),
            "preemptions": sum(p["preemptions"] for p in per),
            "cancelled": sum(p["cancelled"] for p in per),
            "shed": sum(p["shed"] for p in per),
            "collective_ops": sum(p["collective_ops"] for p in per),
            "collectives_per_step": (per[0]["collectives_per_step"]
                                     if per else 0),
            "padding_efficiency": (
                sum(e.scheduled_tokens for e in self.engines)
                / max(sum(e.padded_tokens for e in self.engines), 1)),
            "tokens_decoded_per_slice": [p["tokens_decoded"] for p in per],
            "tokens_prefilled_per_slice": [p["tokens_prefilled"]
                                           for p in per],
            "collective_ops_per_slice": [p["collective_ops"] for p in per],
            "per_slice": per,
        }


# ---------------------------------------------------------------------------
class SlotDecodeEngine:
    """Continuous-batching decode over a fixed dense slot grid: ``n_slots``
    lanes of ``cache_len`` tokens, one token per active lane per step,
    prompts fed token by token.  The oracle of the paged engine."""

    def __init__(self, model_api, params, *, n_slots: int, cache_len: int,
                 eos_token: int = -1, window: int = 0, cache_dtype=None,
                 compute_dtype=None, device="cuda", **_paged_opts) -> None:
        """Build the dense-slot engine (paged-only options are ignored)."""
        self.device = resolve_device(device)
        self.api = model_api
        self.params = params
        emb = _weight(params)
        self.n_slots = n_slots
        self.cache_len = cache_len
        self.eos = eos_token
        self.window = window
        self.cache = model_api.init_cache(
            n_slots, cache_len, window=window,
            dtype=cache_dtype if cache_dtype is not None else emb.dtype,
            device=self.device)
        self._step_kw = {"window": window, "compute_dtype": compute_dtype}
        self.active: List[Optional[Request]] = [None] * n_slots
        self.queue: List[Request] = []
        self._finished: List[Request] = []
        self._slots_per_lane = min(window, cache_len) if window else cache_len
        self._next_id = 0
        self.tokens_decoded = 0
        self.steps = 0
        self.scheduled_tokens = 0
        self.padded_tokens = 0
        self.cancelled = 0
        # times the client callback (``on_token`` span) as the paged
        # engine's tracer does; the slot engine has no other span
        self.trace = Tracer()
        self.clock = None
        self.on_token = None

    def set_clock(self, clock) -> None:
        """Install a virtual clock for latency stamps (None = wall clock)."""
        self.clock = clock

    def _now(self) -> float:
        return self.clock.now if self.clock is not None \
            else time.perf_counter()

    def submit(self, prompt: np.ndarray, max_new_tokens: int,
               priority: int = 0) -> int:
        """Queue a request; returns its id (the slot queue stays FIFO)."""
        rid = self._next_id
        self._next_id += 1
        req = Request(rid, np.asarray(prompt, np.int32), max_new_tokens,
                      priority=priority)
        req.t_submit = self._now()
        self.queue.append(req)
        return rid

    def cancel(self, request_id: int) -> bool:
        """Abort a queued or active request, freeing its slot."""
        for i, req in enumerate(self.queue):
            if req.request_id == request_id:
                del self.queue[i]
                break
        else:
            for slot, req in enumerate(self.active):
                if req is not None and req.request_id == request_id:
                    self.active[slot] = None
                    break
            else:
                return False
        req.done = True
        req.cancelled = True
        req.t_done = self._now()
        self._finished.append(req)
        self.cancelled += 1
        return True

    def _admit(self) -> None:
        for slot in range(self.n_slots):
            if self.active[slot] is None and self.queue:
                req = self.queue.pop(0)
                req.begin_run(slot)
                self.active[slot] = req
                if "slot_positions" in self.cache and "scan" in self.cache:
                    # the transformer family's KV cache: a new occupant
                    # starts at position 0 and never sees its
                    # predecessor's KV.  The recurrent families (zamba2,
                    # xLSTM) and the encoder-decoder (no "scan" key) keep
                    # the reference's behaviour: their lane state, KV and
                    # position carry over to the new occupant.
                    self.cache["slot_positions"][slot] = -1
                    self.cache["pos"][slot] = 0

    def step(self) -> None:
        """One engine iteration: one token per active slot."""
        self._admit()
        tokens = np.zeros((self.n_slots, 1), np.int32)
        for slot, req in enumerate(self.active):
            if req is not None:
                tokens[slot, 0] = req.feed[req.cursor]
        self.scheduled_tokens += sum(1 for a in self.active if a is not None)
        self.padded_tokens += self.n_slots
        logits, self.cache = self.api.decode_step(
            self.params, self.cache,
            torch.from_numpy(tokens).to(self.device), **self._step_kw)
        next_tokens = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
        self.steps += 1
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            emitting = req.cursor >= len(req.feed) - 1
            req.cursor += 1
            if emitting:
                if _emit_token(self, req, int(next_tokens[slot])):
                    req.done = True
                    self.active[slot] = None
                    self._finished.append(req)

    def has_work(self) -> bool:
        """True while requests are queued or occupy a slot."""
        return bool(self.queue) or any(a is not None for a in self.active)

    def run_until_drained(self, max_steps: int = 100_000) -> List[Request]:
        """Step until no work remains; returns the finished requests."""
        for _ in range(max_steps):
            if not self.has_work():
                break
            self.step()
        return self.take_finished()

    def take_finished(self) -> List[Request]:
        """Hand off (and clear) the requests finished since the last call."""
        out, self._finished = self._finished, []
        return out

    def stats(self) -> Dict[str, float]:
        """Engine counters: steps, tokens, occupancy, padding efficiency."""
        n_active = sum(1 for a in self.active if a is not None)
        used = sum(min(r.cursor, self._slots_per_lane)
                   for r in self.active if r is not None)
        return {
            "steps": self.steps,
            "tokens_decoded": self.tokens_decoded,
            "active": n_active,
            "waiting": len(self.queue),
            "preemptions": 0,
            "block_utilization": used / max(
                self.n_slots * self._slots_per_lane, 1),
            "padding_efficiency": (self.scheduled_tokens
                                   / max(self.padded_tokens, 1)),
        }
