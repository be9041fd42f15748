"""The port's serving host side against the reference's, in lockstep.

Both packages' ``KVCacheManager`` + ``Scheduler`` (+ ``NgramProposer``
drafts, prefix cache, CoW, a host swap tier, rewinds, cancels) are driven
with the same request traces; every step must give equal
``StepDecision``s, block tables, CoW and swap-in ops, ``RaggedBatch``
arrays and ``TileMap`` arrays.  The model's role is played by a seeded
generator whose draws both sides share.
"""
import numpy as np
import pytest

from repro.serving import batch as jbatch
from repro.serving import blocks as jblocks
from repro.serving import scheduler as jsched
from repro.serving import spec as jspec
from repro_torch.serving import batch as tbatch
from repro_torch.serving import blocks as tblocks
from repro_torch.serving import scheduler as tsched
from repro_torch.serving import spec as tspec


class _Side:
    """One package's host stack, with a dict host tier wired in."""

    def __init__(self, blocks, sched, spec, *, n_lanes, num_blocks, bs,
                 max_blocks, token_budget, chunk_tokens, draft_k, swap):
        self.kv = blocks.KVCacheManager(num_blocks, bs,
                                        max_blocks_per_seq=max_blocks,
                                        enable_prefix_cache=True)
        self.tier = {}
        if swap:
            self.kv.host_has = self.tier.__contains__
            self.kv.on_swap_out = (
                lambda digest, blk, parent, tokens:
                self.tier.setdefault(digest, blk))
        self.sched = sched.Scheduler(
            sched.SchedulerConfig(n_lanes=n_lanes, token_budget=token_budget,
                                  chunk_tokens=chunk_tokens,
                                  fill_to_bucket=True, draft_k=draft_k,
                                  proposer=spec.NgramProposer()
                                  if draft_k else None),
            self.kv)
        self.Request = sched.Request
        self.reqs = {}


def _decision_key(d):
    return (tuple((r.request_id, r.lane, d.num_scheduled[r.request_id],
                   tuple(d.drafts.get(r.request_id, ())))
                  for r in d.scheduled),
            d.n_prefill, d.n_decode, d.n_prefill_tokens, d.n_decode_tokens,
            d.n_draft_tokens, d.n_admitted, d.n_preempted, d.n_swapped_out,
            d.prefix_cached_tokens)


def _drive(seed, n_lanes, num_blocks, token_budget, chunk_tokens, draft_k,
           swap, steps=60):
    bs, max_blocks, tile = 4, 8, 4
    kw = dict(n_lanes=n_lanes, num_blocks=num_blocks, bs=bs,
              max_blocks=max_blocks, token_budget=token_budget,
              chunk_tokens=chunk_tokens, draft_k=draft_k, swap=swap)
    ref = _Side(jblocks, jsched, jspec, **kw)
    port = _Side(tblocks, tsched, tspec, **kw)
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 50, 8).astype(np.int32)   # a common preamble
    rid = 0
    n_checked = 0
    for _ in range(steps):
        if rng.random() < 0.5 and rid < 14:
            tail = rng.integers(0, 50, int(rng.integers(1, 8)))
            u = rng.random()
            # an exact repeat of the block-aligned preamble forks its tail
            # block copy-on-write; a shared prefix attaches cached blocks
            prompt = (shared if u < 0.35 else np.concatenate([shared, tail])
                      if u < 0.7 else tail).astype(np.int32)
            max_new = int(rng.integers(1, 10))
            if -(-(len(prompt) + max_new) // bs) <= min(max_blocks,
                                                       num_blocks - 1):
                for side in (ref, port):
                    r = side.Request(rid, prompt.copy(), max_new)
                    side.reqs[rid] = r
                    side.sched.add(r)
                rid += 1
        if ref.sched.running and rng.random() < 0.05:
            victim = ref.sched.running[0].request_id
            for side in (ref, port):
                r = side.reqs[victim]
                side.sched.abort(r)
                if side.kv.has_seq(victim):
                    side.kv.release_seq(victim)
        if not ref.sched.has_work():
            assert not port.sched.has_work()
            continue
        try:
            dj = ref.sched.schedule()
        except RuntimeError:
            with pytest.raises(RuntimeError):
                port.sched.schedule()
            break
        dt = port.sched.schedule()
        assert _decision_key(dt) == _decision_key(dj)
        assert port.kv.take_copy_ops() == ref.kv.take_copy_ops()
        assert port.kv.take_swap_ins() == ref.kv.take_swap_ins()
        for r in dj.scheduled:
            np.testing.assert_array_equal(
                port.kv.padded_table(r.request_id),
                ref.kv.padded_table(r.request_id))
        budget = ref.sched._budget()
        assert port.sched._budget() == budget
        bj = jbatch.RaggedBatch.build(dj, ref.kv, n_lanes, bs, cap=budget)
        bt = tbatch.RaggedBatch.build(dt, port.kv, n_lanes, bs, cap=budget)
        for f in ("tokens", "token_lane", "token_pos", "slot_mapping",
                  "last_row"):
            np.testing.assert_array_equal(getattr(bt, f), getattr(bj, f))
        for f in ("q_starts", "seg_lens", "seg_drafts", "total_tokens",
                  "padded_tokens", "n_draft_tokens"):
            assert getattr(bt, f) == getattr(bj, f), f
        tj, tt = bj.tiles(n_lanes, tile), bt.tiles(n_lanes, tile)
        for f in ("meta", "row_tile", "cu_seqlens"):
            np.testing.assert_array_equal(getattr(tt, f), getattr(tj, f))
        assert (tt.n_tiles, tt.tile) == (tj.n_tiles, tj.tile)
        n_checked += 1
        # the model's role, applied identically to both sides
        for r in list(dj.scheduled):
            n = dj.num_scheduled[r.request_id]
            drafts = dj.drafts.get(r.request_id, [])
            base = n - len(drafts)
            accept = int(rng.integers(0, len(drafts) + 1))
            bonus = int(rng.integers(0, 50))
            for side in (ref, port):
                q = side.reqs[r.request_id]
                if q.cursor + base != len(q.feed):
                    q.cursor += n
                    continue
                kept, finished = 0, False
                for tok in [int(t) for t in drafts[:accept]] + [bonus]:
                    kept += 1
                    q.generated.append(tok)
                    q.feed.append(tok)
                    finished = len(q.generated) >= q.max_new_tokens
                    if finished:
                        break
                q.cursor += base + min(kept, accept)
                if finished:
                    side.sched.finish(q)
                elif len(drafts) > accept:
                    side.kv.rewind(q.request_id, q.cursor)
        assert ([r.request_id for r in port.sched.take_shed()]
                == [r.request_id for r in ref.sched.take_shed()])
    for f in ("prefix_hits", "prefix_tokens_reused", "cow_copies",
              "evictions", "rewinds", "tokens_rewound"):
        assert getattr(port.kv, f) == getattr(ref.kv, f), f
    assert port.sched.total_preemptions == ref.sched.total_preemptions
    return n_checked, ref


@pytest.mark.parametrize("seed", range(8))
def test_host_stack_lockstep(seed):
    """Equal decisions, tables, batches and tile maps step for step, over
    budgets, chunk sizes, speculation, tight pools and the swap tier."""
    n_checked, ref = _drive(seed, n_lanes=2 + seed % 3,
                            num_blocks=(9, 11, 25, 40)[seed % 4],
                            token_budget=(0, 7, 16)[seed % 3],
                            chunk_tokens=(1, 5, 16)[seed % 3],
                            draft_k=(0, 2, 4)[seed % 3],
                            swap=seed % 2 == 0)
    assert n_checked > 5


def test_host_stack_lockstep_exercises_cow_spec_and_preemption():
    """Across the traces, the features the port must mirror all fire."""
    seen = {"cow": 0, "hits": 0, "rewinds": 0, "preempt": 0}
    for seed in range(8):
        _, ref = _drive(seed, n_lanes=2 + seed % 3,
                        num_blocks=(9, 11, 25, 40)[seed % 4],
                        token_budget=(0, 7, 16)[seed % 3],
                        chunk_tokens=(1, 5, 16)[seed % 3],
                        draft_k=(0, 2, 4)[seed % 3], swap=seed % 2 == 0)
        seen["cow"] += ref.kv.cow_copies
        seen["hits"] += ref.kv.prefix_hits
        seen["rewinds"] += ref.kv.rewinds
        seen["preempt"] += ref.sched.total_preemptions
    assert all(v > 0 for v in seen.values()), seen


def test_ngram_proposer_matches_reference():
    """Same drafts from the same histories, over n-gram ranges."""
    rng = np.random.default_rng(2)
    for max_ngram, min_ngram, lookback in ((3, 1, 1024), (2, 2, 8),
                                           (4, 1, 16)):
        jp = jspec.NgramProposer(max_ngram, min_ngram, lookback)
        tp = tspec.NgramProposer(max_ngram, min_ngram, lookback)
        for _ in range(200):
            hist = rng.integers(0, 4, int(rng.integers(0, 30))).tolist()
            k = int(rng.integers(0, 6))
            assert tp.propose(hist, k) == jp.propose(hist, k)
