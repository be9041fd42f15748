"""Where a serving step's time goes on the card:
``python -m repro_torch.launch.profile_serve [--arch gemma-7b]``.

Serves the shared-prefix fleet of ``chip_smoke.py`` (the arch at its
published width, gemma-7b by default, random bf16 weights from a seed)
through ``PagedDecodeEngine`` in each of its three layouts -- the default
(segment-tiled), ``tiled=False`` (per-token) and ``ragged=False``
(rectangular) -- twice per layout: a warm-up drain, then a drain under
``torch.profiler``.  Prints, per layout, the wall time per step, the
device's busy share of the profiled window (union of kernel intervals over
the wall), the device time of the attention kernel, the GEMMs, an MoE
arch's router and dispatch kernels and everything else, beside them the
host's self time in each span of the engine's step (``stats()``'s
``span_s.*``; with an MoE arch its stages' device time, ``moe_ms.*``),
per step, and the top device kernels by total time.  Then it drains the
fleet unprofiled ``ROUNDS`` times per layout, rotating which layout goes
first, and prints each layout's wall ms/step and their median (the host
clock of a shared host varies between drains, so one drain per layout is
not a comparison).  ``--tp N`` serves through the tensor-parallel engine on N
mesh positions that all name the card (every shard's kernels and every
reduce run on it).  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import gc
import json
import statistics
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.launch.mesh import Mesh
from repro_torch.models.api import build_model
from repro_torch.serving.engine import PagedDecodeEngine
from repro_torch.serving.tracing import MOE_STAGES, SPANS

TOP = 12          # kernels listed by total device time, per layout
ROUNDS = 3        # unprofiled drains per layout
LAYOUTS = [("default", {}), ("tiled=False", {"tiled": False}),
           ("ragged=False", {"ragged": False})]


def shared_prefix_fleet(vocab: int, seed: int = 0):
    """(first, others): a 128-token prompt whose first 64 tokens are a
    system prompt, its exact repeat (a copy-on-write fork once the first
    is cached), and six prompts of 64-256 tokens sharing the system
    prompt."""
    rng = np.random.default_rng(seed)
    system = rng.integers(0, vocab, 64).astype(np.int32)
    first = np.concatenate([system, rng.integers(0, vocab, 64)
                            .astype(np.int32)])
    others = [first.copy()] + [
        np.concatenate([system, rng.integers(
            0, vocab, int(rng.integers(0, 193))).astype(np.int32)])
        for _ in range(6)]
    return first, others


def serve_fleet(api, params, *, max_new: int = 32, seed: int = 0,
                device="cuda", engine_cls=PagedDecodeEngine, **engine_kw):
    """Drain the fleet through a fresh ``engine_cls`` (the paged engine,
    or ``ShardedDecodeEngine`` with a ``mesh``), default but for
    ``engine_kw`` (e.g. ``ragged=False``, ``tiled=False`` or ``mesh=``);
    returns (engine, finished requests, wall seconds)."""
    first, others = shared_prefix_fleet(api.cfg.vocab_size, seed)
    # an engine and its block manager reference each other (the swap
    # callback): collect finished engines, whose parameter shards on a
    # mesh hold a model's worth of memory, before building another
    gc.collect()
    eng = engine_cls(api, params, n_slots=8, cache_len=512,
                     window=api.effective_window(512), device=device,
                     **engine_kw)
    slices = getattr(eng, "engines", [eng])
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    t0 = time.perf_counter()
    eng.submit(first, max_new)
    while not any(r.generated for e in slices for r in e.scheduler.running):
        eng.step()                   # the system prompt's blocks register
    for p in others:
        eng.submit(p, max_new)
    finished = eng.run_until_drained()
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    return eng, finished, time.perf_counter() - t0


# device kernels of the MoE router (models/moe.py: the softmaxes, top-k
# and its sort, the capacity cumsum, the experts' one-hot), by the names
# the deepseek-moe-16b profiles on an H100 showed.  The router's float32
# logits product counts as a GEMM; its slot compares, sums and products
# run PyTorch's generic elementwise and reduce kernels, which norms and
# RoPE share, and stay in "other"
ROUTER_KERNELS = ("softmax_warp_forward", "gatherTopK",
                  "bitonicSortKVInPlace", "tensor_kernel_scan_outer_dim",
                  "_cuda_scatter_fill")


def _group(name: str, moe: bool = False) -> str:
    """Kernel family of a device kernel name (the paged reads: the FMA
    kernels and the bf16 split sweep with its combine; with ``moe``, the
    router and dispatch: ROUTER_KERNELS)."""
    if any(k in name for k in ("paged_attention_kernel",
                               "paged_split::split_")):
        return "attention"
    if any(k in name for k in ("nvjet", "gemm", "splitKreduce", "cutlass")):
        return "gemm"
    if moe and any(k in name for k in ROUTER_KERNELS):
        return "router"
    return "other"


def _busy_us(events) -> float:
    """Union of device kernel intervals, in microseconds."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def profile_layout(api, params, label: str, engine_kw) -> dict:
    """Warm-up drain, then a profiled drain, of the fleet through the
    engine with ``engine_kw``; prints and returns the breakdown."""
    eng, _, wall = serve_fleet(api, params, **engine_kw)
    print(f"[{label}] warm-up: steps={eng.steps} wall_s={wall:.3f}",
          flush=True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        eng, finished, wall = serve_fleet(api, params, **engine_kw)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _busy_us(kernels) / 1e6
    print(f"[{label}] profiled: layers={api.cfg.n_layers} steps={eng.steps} "
          f"tokens={eng.tokens_decoded} wall_s={wall:.4f} "
          f"ms_per_step={wall / eng.steps * 1e3:.3f} "
          f"device_busy_s={busy:.4f} busy_share={busy / wall:.4f} "
          f"idle_share={1 - busy / wall:.4f} kernels={len(kernels)}",
          flush=True)
    moe = api.cfg.moe is not None
    totals = {}
    groups = {"attention": 0.0, "gemm": 0.0, "router": 0.0, "other": 0.0}
    for e in kernels:
        t = totals.setdefault(e.name, [0.0, 0])
        us = e.time_range.end - e.time_range.start
        t[0] += us
        t[1] += 1
        groups[_group(e.name, moe)] += us
    total_us = sum(groups.values())
    for g, us in groups.items():
        print(f"  group {g}: {us / 1e3 / eng.steps:.3f} ms/step, "
              f"{us / total_us:.4f} of kernel time", flush=True)
    st = eng.stats()
    spans = {n: 1e3 * st[f"span_s.{n}"] / eng.steps for n in SPANS}
    if st["moe_traced_steps"]:
        spans.update({f"moe {s}": st[f"moe_ms.{s}"] / st["moe_traced_steps"]
                      for s in MOE_STAGES})
    print("  spans (self ms/step): " + ", ".join(
        f"{n} {ms:.3f}" for n, ms in spans.items()), flush=True)
    rows = sorted(totals.items(), key=lambda kv: -kv[1][0])[:TOP]
    for name, (us, n) in rows:
        print(f"  {us / 1e3:10.3f} ms  {n:6d} calls  "
              f"{us / 1e3 / eng.steps:8.3f} ms/step  {_group(name, moe):9s} "
              f"{name[:120]}")
    return {"steps": eng.steps, "wall_s": wall, "device_busy_s": busy,
            "groups_ms": {g: us / 1e3 for g, us in groups.items()},
            "spans_ms_per_step": spans,
            "top": [[n[:90], us / 1e3, c] for n, (us, c) in rows]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-7b")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel positions, all on the card")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA card")
    mesh = {} if args.tp == 1 else {"mesh": Mesh(
        [torch.device("cuda", 0)] * args.tp, ("data", "model"),
        shape=(1, args.tp))}
    layouts = [(label if args.tp == 1 else f"TP {args.tp} {label}",
                {**kw, **mesh}) for label, kw in LAYOUTS]
    cfg = get_config(args.arch)
    api = build_model(cfg)
    params = api.init(seed=0, device="cuda", dtype=torch.bfloat16)
    print(f"{cfg.name}: layers={cfg.n_layers} d_model={cfg.d_model} "
          f"heads={cfg.n_heads}/{cfg.n_kv_heads}x{cfg.resolved_head_dim} "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB of weights",
          flush=True)
    out = {label: profile_layout(api, params, label, kw)
           for label, kw in layouts}
    walls = {label: [] for label, _ in layouts}
    for r in range(ROUNDS):
        for label, kw in layouts[r:] + layouts[:r]:
            eng, _, wall = serve_fleet(api, params, **kw)
            walls[label].append(wall / eng.steps * 1e3)
    for label, ms in walls.items():
        out[label]["unprofiled_ms_per_step"] = ms
        print(f"[{label}] unprofiled ms/step over {ROUNDS} rotated drains: "
              f"{', '.join(f'{m:.3f}' for m in ms)} "
              f"(median {statistics.median(ms):.3f})", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
