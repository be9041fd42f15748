"""Edge serving on the port, from edge inference to DC-disaggregated LLMs,
``python -m repro_torch.launch.edge_serving [--device cuda|cpu]``.

The counterpart of ``examples/edge_serving.py``, in four stages:

1. **BraggNN at the edge** — the paper's edge inference op through
   ``BatchEngine`` (dynamic micro-batching of ragged requests).
2. **One-engine baseline** — a shared-system-prompt fleet served by one
   ``PagedDecodeEngine`` (chunked prefill, prefix sharing, copy-on-write,
   speculative decode).
3. **Disaggregated serving** — the same fleet through
   ``DisaggregatedEngine``: prefill in the data center, the prompts' KV
   blocks shipped as content-hashed ``KVShipment``s priced by the paper's
   §4.1 transfer model (the shared preamble crosses once), decode at the
   edge; token-identical to stage 2.
4. **Prefix-cache persistence** — the edge engine's cache saved in the
   wire format, a restarted engine loads it, and a warm prompt serves
   with cache hits and unchanged tokens.

The LM is gemma-7b's smoke config in float32 (random weights from a
seed), so the handoff check and the token comparisons are exact.  It
runs on the CUDA card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch.configs import BraggNNConfig, get_config
from repro_torch.data.synthetic import bragg_patches
from repro_torch.device import resolve_device
from repro_torch.models import braggnn
from repro_torch.models.api import build_model
from repro_torch.serving import (BatchEngine, DisaggregatedEngine,
                                 PagedDecodeEngine)

# one fleet shape, reused by stages 2-4
N_REQUESTS, MAX_NEW, PREAMBLE_LEN = 8, 8, 32


def serve_braggnn(dev) -> None:
    """Stage 1: the paper's edge inference op under dynamic batching."""
    cfg = BraggNNConfig()
    params = braggnn.init_params(cfg, seed=0, device=dev)
    eng = BatchEngine(lambda p, x: braggnn.forward(p, x, cfg), params,
                      max_batch=256, device=dev)
    rng = np.random.default_rng(0)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    t0 = time.perf_counter()
    total = 0
    for _ in range(8):                      # ragged request sizes
        n = int(rng.integers(3, 300))
        d = bragg_patches(g, n, device=dev)
        out = eng.infer(d["patches"].cpu().numpy())
        if out.shape != (n, 2) or not np.isfinite(out).all():
            raise AssertionError(f"BraggNN estimates {out.shape}")
        total += n
    dt = time.perf_counter() - t0
    print(f"[1] BraggNN BatchEngine: {eng.stats.summary()} "
        f"({total / dt:.0f} peaks/s)")


def build_fleet(vocab_size: int) -> List[np.ndarray]:
    """N requests opening with one standing preamble, from fixed seeds, so
    stages 2 and 3 serve the same prompts."""
    rng = np.random.default_rng(2)
    preamble = rng.integers(0, vocab_size, PREAMBLE_LEN).astype(np.int32)
    gen = np.random.default_rng(3)
    return [np.concatenate(
        [preamble, gen.integers(0, vocab_size, 5).astype(np.int32)])
        for _ in range(N_REQUESTS)]


def make_engine(api, params, dev):
    """One edge-shaped paged engine (the same knobs for every stage)."""
    return PagedDecodeEngine(api, params, n_slots=2, cache_len=128,
                             block_size=8, chunk_tokens=16,
                             prefix_cache=True, device=dev)


def serve_one_engine(api, params, prompts, dev):
    """Stage 2: the local baseline; returns ({id: tokens}, wall s)."""
    eng = make_engine(api, params, dev)
    for p in prompts:
        eng.submit(p, MAX_NEW)
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    wall = time.perf_counter() - t0
    s = eng.stats()
    print(f"[2] one-engine baseline: {len(done)} requests in {eng.steps} "
        f"steps, {wall:.4f}s wall; prefix cache reused "
        f"{s['prefix_tokens_reused']} prompt tokens ({s['prefix_hits']} "
        f"hits, {s['cow_copies']} CoW copies)")
    return {r.request_id: list(r.generated) for r in done}, wall


def serve_disaggregated(api, params, prompts, baseline, base_wall,
                        dev) -> DisaggregatedEngine:
    """Stage 3: DC prefill -> KV over the WAN -> edge decode, the DC
    modeled 8x faster than the edge, a 10 Gbps DTN link with 48 ms RTT."""
    dis = DisaggregatedEngine(make_engine(api, params, dev),
                              make_engine(api, params, dev),
                              nic_bps=1.25e9, dc_speedup=8.0)
    rids = [dis.submit(p, MAX_NEW) for p in prompts]
    done = {r.request_id: list(r.generated)
            for r in dis.run_until_drained()}
    if [done[r] for r in rids] != [baseline[r] for r in sorted(baseline)]:
        raise AssertionError("disaggregated tokens differ from the "
                             "one-engine baseline")
    s = dis.stats()
    print(f"[3] disaggregated: {len(rids)} requests, token-identical to the "
        f"one-engine baseline")
    print(f"    shipped {s['bytes_shipped']:,} B vs {s['bytes_naive']:,} B "
        f"naive: dedup saved {s['dedup_savings']:.1%} "
        f"({s['blocks_dedup_skipped']} of {s['blocks_exported']} blocks "
        "never crossed the WAN)")
    t = dis.priced_turnaround()
    print(f"    modeled turnaround: prefill {t['prefill'] * 1e3:.3f} ms + "
        f"transfer {t['transfer'] * 1e3:.3f} ms + decode "
        f"{t['decode'] * 1e3:.3f} ms = {t['total'] * 1e3:.3f} ms "
        f"(one-engine wall: {base_wall * 1e3:.3f} ms)")
    xo = dis.crossover_bandwidth(base_wall)
    if xo is None:
        floor = dis.priced_turnaround(1e18)["total"]
        print(f"    crossover: none; even an infinite link leaves a "
            f"{floor * 1e3:.3f} ms floor (startup + RTT) above the "
            "one-engine wall")
    else:
        print(f"    crossover: the split wins above {xo:.4g} B/s")
    if not (s["bytes_shipped"] < s["bytes_naive"]
            and s["blocks_dedup_skipped"] > 0):
        raise AssertionError("the shared preamble crossed more than once")
    return dis


def persist_and_restart(api, params, dis, prompts, baseline,
                        dev) -> Dict[str, int]:
    """Stage 4: the edge engine's cache saved in the wire format, loaded
    by a restarted engine; a warm prompt hits it, tokens unchanged."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "prefix_cache.kvship")
        nbytes = dis.decode.save_prefix_cache(path)
        fresh = make_engine(api, params, dev)
        loaded = fresh.load_prefix_cache(path)
    fresh.submit(prompts[0], MAX_NEW)
    done = fresh.run_until_drained()
    s = fresh.stats()
    if not (s["prefix_hits"] > 0
            and done[0].generated == baseline[min(baseline)]):
        raise AssertionError("the restarted engine missed its cache or "
                             "changed the tokens")
    print(f"[4] persistence: snapshot {nbytes:,} B, restarted engine imported "
        f"{loaded['imported']} blocks and served a warm prompt with "
        f"{s['prefix_tokens_reused']} tokens from cache, tokens unchanged")
    return {"snapshot_bytes": nbytes, **loaded}


def main(argv=None) -> None:
    """Run the four stages; raise where an output differs."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    serve_braggnn(dev)
    api = build_model(get_config("gemma-7b").smoke_variant())
    params = api.init(seed=0, device=dev, dtype=torch.float32)
    prompts = build_fleet(api.cfg.vocab_size)
    baseline, base_wall = serve_one_engine(api, params, prompts, dev)
    dis = serve_disaggregated(api, params, prompts, baseline, base_wall,
                              dev)
    persist_and_restart(api, params, dis, prompts, baseline, dev)
    print("edge_serving OK")


if __name__ == "__main__":
    main()
