"""Crossover analysis on the port: when does shipping work to the DC beat
staying local?  ``python -m repro_torch.launch.crossover_analysis
[--device cuda|cpu]``.

The counterpart of ``examples/crossover_analysis.py``, in its three
stages, on ``repro_torch.core`` and the port's serving stack:

  1. **§4.2, training** (the paper's Figure-4 analysis): conventional
     peak analysis at the DC vs the ML-surrogate workflow, as a function
     of the number of Bragg peaks N and the DCAI training time T.
  2. **Serving, measured**: one-engine serving vs the disaggregated
     split (prefill in the data center, paged-KV blocks over the WAN,
     decode at the edge).  Both come from *one* served fleet:
     ``DisaggregatedEngine`` records every shipment, so
     ``priced_turnaround(nic_bps)`` re-prices the run at any link
     bandwidth, and ``crossover_bandwidth()`` bisects for the break-even
     link.  The LM is gemma-7b's smoke config in float32 (random weights
     from a seed), so the split must give the one-engine run's tokens.
  3. **Serving at production scale, modeled**: the same §4.1 transfer
     model on a 7B-class workload (GQA KV at fp16, long prompts), where
     prefill takes minutes and the split wins at the paper's 10 Gbps
     DTN link.

It runs on the CUDA card unless ``--device cpu`` is given, and prints
the reference's three tables.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time
from typing import Dict

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import build_system
from repro_torch.device import resolve_device
from repro_torch.models.api import build_model
from repro_torch.serving import DisaggregatedEngine, PagedDecodeEngine
from repro_torch.serving.transfer import edge_dc_topology

# --- stage 2/3 knobs ------------------------------------------------------
BW_SWEEP = (1e5, 1e6, 1e7, 1e8, 1.25e9, 1e10)   # bytes/s, DTN NIC = 1.25e9
DC_SPEEDUP = 8.0                                 # modeled DCAI : edge ratio

# --- stage 3: a 7B-class production workload (modeled) --------------------
KV_BYTES_PER_TOKEN = 2 * 32 * 8 * 128 * 2   # k+v, 32 layers, GQA 8x128, fp16
EDGE_PREFILL_TOK_S = 1_000.0                # edge-GPU 7B prefill throughput
WIRE_BLOCK_TOKENS = 256                     # tokens per shipped payload file
DECODE_S = 10.0                             # decode wall, identical both ways


def training_crossover(log=print) -> None:
    """Stage 1: the paper's §4.2 model-based analysis."""
    cm = build_system().costmodel

    log("[1] training crossover (paper §4.2, Figure-4 style)")
    log("    N peaks    conventional@DC   ML surrogate    winner")
    for n in (10**4, 10**5, 10**6, 10**7, 10**8, 10**9):
        conv = cm.f_conventional_dc(n)
        ml = cm.f_ml(n, p=0.1)
        win = "ML" if ml.total < conv.total else "conventional"
        log(f"    {n:7.0e}   {conv.total:12.1f}s   {ml.total:11.1f}s"
            f"    {win}")
    log(f"    crossover N* = {cm.crossover(p=0.1):,} peaks "
        "(p=10%, T=19s Cerebras)")
    for p in (0.02, 0.05, 0.1, 0.2):
        log(f"      p={p:4.2f}: N* = {cm.crossover(p=p):,}")
    names = {6.0: "Cerebras (CookieNetAE)", 19.0: "Cerebras (BraggNN)",
             139.0: "SambaNova 1-RDU", 1102.0: "local V100"}
    for t in (6.0, 19.0, 139.0, 1102.0):
        cm2 = build_system().costmodel
        cm2.costs = dataclasses.replace(cm2.costs, train=t)
        log(f"      T={t:7.1f}s: N* = {cm2.crossover(p=0.1):,}"
            f"  ({names[t]})")


def serving_crossover_measured(device="cuda", log=print) -> Dict:
    """Stage 2: serve one fleet both ways, re-price across bandwidths.
    Returns the two runs' tokens in submission order (``local``,
    ``split``), the one-engine wall and the coordinator."""
    dev = resolve_device(device)
    cfg = get_config("gemma-7b").smoke_variant()
    api = build_model(cfg)
    params = api.init(seed=0, device=dev, dtype=torch.float32)

    # a shared-preamble fleet (the federated real-time shape)
    rng = np.random.default_rng(11)
    preamble = rng.integers(0, cfg.vocab_size, 40).astype(np.int32)
    prompts = [np.concatenate(
        [preamble, rng.integers(0, cfg.vocab_size, 6).astype(np.int32)])
        for _ in range(6)]

    def make():
        return PagedDecodeEngine(api, params, n_slots=2, cache_len=128,
                                 block_size=8, chunk_tokens=16,
                                 prefix_cache=True, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # a first drain outside the timed comparison (the kernels' first
    # launches, the allocator's first blocks)
    warm = make()
    for p in prompts:
        warm.submit(p, 8)
    warm.run_until_drained()

    # one-engine baseline
    base = make()
    ids = [base.submit(p, 8) for p in prompts]
    sync()
    t0 = time.perf_counter()
    ref = {r.request_id: r.generated for r in base.run_until_drained()}
    sync()
    base_wall = time.perf_counter() - t0

    # disaggregated: same prompts, two engines, the §4.1 cost model
    dis = DisaggregatedEngine(make(), make(), nic_bps=1.25e9,
                              dc_speedup=DC_SPEEDUP)
    rids = [dis.submit(p, 8) for p in prompts]
    done = {r.request_id: r.generated for r in dis.run_until_drained()}
    local = [list(ref[i]) for i in ids]
    split = [list(done[r]) for r in rids]
    if split != local:
        raise AssertionError("the split's tokens differ from one engine's")

    s = dis.stats()
    log(f"\n[2] serving crossover, measured (smoke model, "
        f"{len(prompts)} requests, {dev.type})")
    log(f"    token-identical to one-engine; dedup saved "
        f"{s['dedup_savings']:.0%} of shipped bytes")
    log("    link B/s     prefill_s  transfer_s  decode_s   total_s"
        "   vs local")
    for bw in BW_SWEEP:                       # plot-ready sweep data
        t = dis.priced_turnaround(bw)
        verdict = "split" if t["total"] <= base_wall else "local"
        log(f"    {bw:8.0e}   {t['prefill']:9.3f} {t['transfer']:11.3f}"
            f" {t['decode']:9.3f} {t['total']:9.3f}   {verdict}")
    log(f"    one-engine baseline: {base_wall:.3f}s")
    xo = dis.crossover_bandwidth(base_wall)
    if xo is None:
        floor = dis.priced_turnaround(1e18)["total"]
        log(f"    crossover: none — infinite-bandwidth floor "
            f"{floor:.3f}s still loses; serve locally at this scale")
    else:
        log(f"    crossover: split wins above {xo:.3g} B/s "
            f"({'below' if xo <= 1.25e9 else 'ABOVE'} the paper's "
            "1.25e9 B/s DTN link)")
    return {"local": local, "split": split, "base_wall": base_wall,
            "coordinator": dis}


def _modeled_split(prompt_tokens: int, nic_bps: float) -> dict:
    """Price a production-scale split with the §4.1 model.

    Edge prefill wall is ``tokens / EDGE_PREFILL_TOK_S``; the DC runs it
    ``DC_SPEEDUP``x faster; the prompt's KV
    (``tokens * KV_BYTES_PER_TOKEN``) crosses the WAN as one manifest
    plus one payload file per ``WIRE_BLOCK_TOKENS`` tokens, as
    ``DisaggregatedEngine`` files its shipments.
    """
    link = edge_dc_topology(nic_bps).link("dc", "edge")
    prefill_edge = prompt_tokens / EDGE_PREFILL_TOK_S
    n_files = 1 + math.ceil(prompt_tokens / WIRE_BLOCK_TOKENS)
    conc = min(8, n_files)
    xfer = (prompt_tokens * KV_BYTES_PER_TOKEN / link.effective_rate(conc)
            + link.per_file_startup * math.ceil(n_files / conc)
            + 2 * link.rtt)
    local = prefill_edge + DECODE_S
    split = prefill_edge / DC_SPEEDUP + xfer + DECODE_S
    return {"local": local, "split": split, "transfer": xfer}


def serving_crossover_modeled(log=print) -> None:
    """Stage 3: the same model at production scale, where the split
    wins."""
    log("\n[3] serving crossover, modeled (7B-class KV, "
        f"{KV_BYTES_PER_TOKEN} B/token, edge prefill "
        f"{EDGE_PREFILL_TOK_S:.0f} tok/s, DC {DC_SPEEDUP:.0f}x)")
    log("    prompt tok    local_s    split_s   (transfer_s)   winner")
    for n in (1_000, 10_000, 50_000, 100_000, 500_000):
        m = _modeled_split(n, nic_bps=1.25e9)
        win = "split" if m["split"] < m["local"] else "local"
        log(f"    {n:10,} {m['local']:10.1f} {m['split']:10.1f}"
            f"   ({m['transfer']:8.1f})     {win}")
    m = _modeled_split(500_000, nic_bps=1.25e9)
    log(f"    at the 500k-token long-prompt shape the split wins "
        f"{m['local'] / m['split']:.1f}x on the paper's 10 Gbps link")


def run(*, device="cuda", log=print) -> Dict:
    """The three stages; returns stage 2's result."""
    dev = resolve_device(device)
    training_crossover(log)
    measured = serving_crossover_measured(dev, log)
    serving_crossover_modeled(log)
    return measured


def main(argv=None) -> None:
    """Run the three stages once; raise if the split's tokens differ
    from one engine's."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    run(device=args.device)
    print("crossover_analysis OK")


if __name__ == "__main__":
    main()
