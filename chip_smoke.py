#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``): the quickest
proof that the port still starts on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card (an H100 for the ``sm_90a`` kernels), ``nvcc`` and
the repository's ``src/``; it exits non-zero without them.  Phases, each
printing its own line(s):

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every kernel of the port from the sources in the checkout;
3. each kernel against its plain PyTorch version on the card, at the
   main path's shapes (gemma-7b bf16 and int8 pools, starcoder2-7b GQA
   with a sliding window), with its time, the plain version's, one
   PyTorch library call's and the least time the card could take;
4. the main path: ``PagedDecodeEngine`` with its defaults serving
   gemma-7b at its published width (all 28 layers, random bf16 weights
   from a seed) on requests that share a system prompt; every step must
   have gone through the kernel (launches == layers x steps);
5. one full-width ``ragged_step`` with the kernel against the same step
   on the plain path, on the same pools.

Then one JSON line of per-kernel numbers, and last
``{"ok": true, "device": {...}}``.  Any failed phase raises, so the run
exits non-zero without that last line.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
BF16_FLOPS = 989e12           # H100 SXM dense bf16 tensor-core peak
SEED = 0
DEVICE = "cuda"


def _median_ms(fn, reps: int, inner: int = 10, warmup: int = 2) -> float:
    """Median over ``reps`` of the CUDA-event time of ``inner`` back-to-back
    calls of ``fn()``, per call, in ms (back to back, so the host's
    launch overhead hides behind the queued work)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phase 3: kernel against its plain version
# ---------------------------------------------------------------------------
def _mixed_stream(*, Hkv, G, D, bs, tile, pool_dtype, window, seed):
    """A mixed flat stream like the main path's: prefill segments of
    64-256 tokens (one starting past a cached prefix), decodes at long
    contexts, speculative 1+4 draft segments, windows straddling segment
    boundaries, and inert capacity tiles; pools hold earlier context."""
    import numpy as np
    import torch
    from repro_torch.serving.batch import build_tile_map
    segments = [(0, 200), (64, 100), (300, 37), (517, 1), (901, 1),
                (130, 1), (764, 1), (480, 5), (622, 5), (1000, 1)]
    max_blocks = -(-1024 // bs)
    n_lanes = len(segments)
    num_blocks = n_lanes * max_blocks + 1
    rng = np.random.default_rng(seed)
    tables = np.zeros((n_lanes, max_blocks), np.int32)
    free = list(rng.permutation(np.arange(1, num_blocks)))
    offs, lens, lanes, pos0 = [], [], [], []
    off = 0
    for lane, (start, n) in enumerate(segments):
        for j in range(-(-(start + n) // bs)):
            tables[lane, j] = free.pop()
        offs.append(off); lens.append(n); lanes.append(lane)
        pos0.append(start)
        off += n
    T = off
    T_pad = 1 << (T - 1).bit_length()
    tm = build_tile_map(offs, lens, lanes, pos0, T_pad, n_lanes, tile)
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    H = Hkv * G
    q = torch.randn((T_pad, H, D), generator=g, device=dev,
                    dtype=torch.float32).to(torch.bfloat16)
    shape = (num_blocks, bs, Hkv, D)
    scales = {}
    if pool_dtype == torch.int8:
        k = torch.randint(-127, 128, shape, generator=g, device=dev,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, shape, generator=g, device=dev,
                          dtype=torch.int8)
        for name in ("k_scale", "v_scale"):
            scales[name] = (torch.rand(shape[:3], generator=g, device=dev)
                            * 0.02 + 0.002)
    else:
        k = torch.randn(shape, generator=g, device=dev).to(pool_dtype)
        v = torch.randn(shape, generator=g, device=dev).to(pool_dtype)
    t32 = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return dict(q=q, k=k, v=v, scales=scales, tables=t32(tables),
                meta=t32(tm.meta), row_tile=t32(tm.row_tile), tile=tile,
                window=window, T=T, segments=segments, bs=bs,
                tables_np=tables, meta_np=tm.meta)


def _bound(s) -> tuple:
    """Least time for the work this stream needs: each needed K/V block
    (and scale) read once, q read and the real rows written once, plus
    the metadata, over the memory rate; QK and PV FLOPs over the valid
    keys of every real row at the bf16 peak.  Returns (ms, bound_by)."""
    import numpy as np
    q, k = s["q"], s["k"]
    Hkv, D = k.shape[2], k.shape[3]
    H = q.shape[1]
    bs, window = s["bs"], s["window"]
    needed = set()
    flops = 0
    for lane, (start, n) in enumerate(s["segments"]):
        first_key = max(0, start - window + 1) if window else 0
        for j in range(first_key // bs, (start + n - 1) // bs + 1):
            needed.add(int(s["tables_np"][lane, j]))
        for p in range(start, start + n):
            keys = min(p + 1, window) if window else p + 1
            flops += 4 * D * keys * H
    elem = k.element_size()
    kv_bytes = len(needed) * bs * Hkv * (D * elem + (4 if s["scales"]
                                                     else 0)) * 2
    qo_bytes = 2 * s["T"] * H * D * q.element_size()
    meta_bytes = s["tables_np"].nbytes + s["meta_np"].nbytes
    byte_ms = (kv_bytes + qo_bytes + meta_bytes) / HBM_BYTES_PER_S * 1e3
    flop_ms = flops / BF16_FLOPS * 1e3
    return (byte_ms, "bytes") if byte_ms >= flop_ms else (flop_ms,
                                                          "operations")


def _library_call(s):
    """``scaled_dot_product_attention`` over the same stream, one call:
    each segment's q rows against its lane's gathered span, padded to
    the longest segment and deepest span, with a causal/window mask.
    Built once here; only the call is timed (a yardstick, never used by
    the port)."""
    import torch
    import torch.nn.functional as F
    q, k, v = s["q"], s["k"], s["v"]
    Hkv, D = k.shape[2], k.shape[3]
    H = q.shape[1]
    bs = s["bs"]
    segs = s["segments"]
    Lq = max(n for _, n in segs)
    S = max(-(-(st + n) // bs) for st, n in segs) * bs
    B = len(segs)
    dev = q.device
    qb = torch.zeros((B, H, Lq, D), dtype=q.dtype, device=dev)
    kb = torch.zeros((B, H, S, D), dtype=q.dtype, device=dev)
    vb = torch.zeros((B, H, S, D), dtype=q.dtype, device=dev)
    mask = torch.zeros((B, 1, Lq, S), dtype=torch.bool, device=dev)
    off = 0
    for b, (start, n) in enumerate(segs):
        nblk = -(-(start + n) // bs)
        blocks = s["tables"][b, :nblk].long()
        ks = k[blocks].reshape(nblk * bs, Hkv, D)
        vs = v[blocks].reshape(nblk * bs, Hkv, D)
        if s["scales"]:
            ks = ks.float() * s["scales"]["k_scale"][blocks].reshape(
                nblk * bs, Hkv, 1)
            vs = vs.float() * s["scales"]["v_scale"][blocks].reshape(
                nblk * bs, Hkv, 1)
        G = H // Hkv
        kb[b, :, :nblk * bs] = ks.to(q.dtype).repeat_interleave(
            G, dim=1).transpose(0, 1)
        vb[b, :, :nblk * bs] = vs.to(q.dtype).repeat_interleave(
            G, dim=1).transpose(0, 1)
        qb[b, :, :n] = q[off:off + n].transpose(0, 1)
        qpos = start + torch.arange(n, device=dev)[:, None]
        kpos = torch.arange(S, device=dev)[None, :]
        m = kpos <= qpos
        if s["window"]:
            m &= (qpos - kpos) < s["window"]
        mask[b, 0, :n] = m
        mask[b, 0, n:, 0] = True       # padded q rows: one visible key
        off += n
    return lambda: F.scaled_dot_product_attention(qb, kb, vb,
                                                  attn_mask=mask)


def phase_kernel_checks():
    """B1 against its plain version at three configurations.  Returns
    the per-config results; raises if any disagrees."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref
    configs = [
        # name, Hkv, G, D, pool dtype, window, tolerance on max |err|
        ("gemma-7b bf16", 16, 1, 256, torch.bfloat16, 0, 5e-2),
        ("gemma-7b int8", 16, 1, 256, torch.int8, 0, 5e-2),
        ("starcoder2-7b bf16 window", 4, 9, 128, torch.bfloat16, 256, 5e-2),
    ]
    results = {}
    for name, Hkv, G, D, pdt, window, tol in configs:
        s = _mixed_stream(Hkv=Hkv, G=G, D=D, bs=16, tile=16, pool_dtype=pdt,
                          window=window, seed=SEED)
        args = (s["q"], s["k"], s["v"], s["tables"], s["meta"],
                s["row_tile"])
        kw = dict(tile=s["tile"], window=window, **s["scales"])
        got = ops.paged_attention_ragged_tiled(*args, use_kernel=True, **kw)
        want = kref.paged_attention_ragged_tiled_reference(*args, **kw)
        torch.cuda.synchronize()
        T = s["T"]
        err = (got[:T].float() - want[:T].float()).abs().max().item()
        finite = bool(torch.isfinite(got[:T]).all())
        ms = _median_ms(lambda: ops.paged_attention_ragged_tiled(
            *args, use_kernel=True, **kw), reps=20)
        plain_ms = _median_ms(lambda: ops.paged_attention_ragged_tiled(
            *args, use_kernel=False, **kw), reps=5)
        lib = _library_call(s)
        library_ms = _median_ms(lib, reps=10)
        bound_ms, bound_by = _bound(s)
        n_tiles = int((s["meta"][2] > s["meta"][1]).sum())
        print(f"kernel check [{name}]: T={T} (padded {s['q'].shape[0]}) "
              f"tiles={n_tiles}/{s['meta'].shape[1]} Hkv={Hkv} G={G} D={D} "
              f"bs=16 tile=16 window={window} pool={str(pdt)[6:]} "
              f"max_abs_err={err:.3e} (tol {tol:g}) ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
              f"bound_ms={bound_ms:.4f} ({bound_by})", flush=True)
        if not finite or not err <= tol:
            raise AssertionError(f"kernel disagrees with its plain version "
                                 f"[{name}]: max_abs_err={err} tol={tol} "
                                 f"finite={finite}")
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             library_ms=library_ms, bound_ms=bound_ms,
                             bound_by=bound_by)
    return results


# ---------------------------------------------------------------------------
# phase 4: the main path at full width
# ---------------------------------------------------------------------------
def phase_main_path(api, params):
    """Serve gemma-7b requests through the default paged engine; returns
    (engine, launches during the run)."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.profile_serve import serve_fleet
    cfg = api.cfg
    max_new = 32
    pa.reset_launch_counts()
    eng, finished, wall = serve_fleet(api, params, max_new=max_new,
                                      seed=SEED, device=DEVICE)
    launches = pa.launch_counts[pa.KERNEL]
    s = eng.stats()
    print(f"main path: gemma-7b full width (d_model={cfg.d_model}, "
          f"{cfg.n_heads}x{cfg.resolved_head_dim} heads, d_ff={cfg.d_ff}, "
          f"vocab={cfg.vocab_size}, layers={cfg.n_layers}) "
          f"requests={len(finished)} steps={eng.steps} "
          f"tokens={eng.tokens_decoded} prefilled={eng.tokens_prefilled} "
          f"wall_s={wall:.3f} tok_per_s={eng.tokens_decoded / wall:.2f} "
          f"ms_per_step={wall / eng.steps * 1e3:.2f} "
          f"kernel_launches={launches}", flush=True)
    print(f"main path stats: {json.dumps(s)}", flush=True)
    if len(finished) != 8:
        raise AssertionError(f"{len(finished)} of 8 requests finished")
    if not all(len(r.generated) == max_new for r in finished):
        raise AssertionError("a request finished without its tokens")
    if launches != cfg.n_layers * eng.steps:
        raise AssertionError(f"kernel launches {launches} != layers x "
                             f"steps {cfg.n_layers * eng.steps}")
    if not (s["prefix_hits"] > 0 and s["cow_copies"] > 0
            and s["spec_verifications"] > 0):
        raise AssertionError("prefix cache, CoW or speculation did not run")
    return eng, launches


# ---------------------------------------------------------------------------
# phase 5: one full-width step, kernel against plain path
# ---------------------------------------------------------------------------
def phase_step_vs_plain(api, params):
    import numpy as np
    import torch
    from repro_torch.serving.batch import build_tile_map
    cfg = api.cfg
    bs, tile, max_blocks = 16, 16, 32
    segments = [(0, 100), (128, 60), (300, 1), (200, 5), (450, 1)]
    n_lanes = len(segments)
    rng = np.random.default_rng(SEED + 1)
    tables = np.zeros((n_lanes, max_blocks), np.int32)
    free = list(rng.permutation(np.arange(1, n_lanes * max_blocks + 1)))
    tokens, pos, slots = [], [], []
    offs, lens, lanes, pos0 = [], [], [], []
    for lane, (start, n) in enumerate(segments):
        for j in range(-(-(start + n) // bs)):
            tables[lane, j] = free.pop()
        offs.append(len(tokens)); lens.append(n); lanes.append(lane)
        pos0.append(start)
        for p in range(start, start + n):
            tokens.append(int(rng.integers(0, cfg.vocab_size)))
            pos.append(p)
            slots.append(int(tables[lane, p // bs]) * bs + p % bs)
    T = len(tokens)
    T_pad = 1 << (T - 1).bit_length()
    pad = [0] * (T_pad - T)
    tm = build_tile_map(offs, lens, lanes, pos0, T_pad, n_lanes, tile)
    cache = api.init_paged_cache(n_lanes, num_blocks=n_lanes * max_blocks
                                 + 1, block_size=bs,
                                 max_blocks_per_lane=max_blocks,
                                 dtype=torch.bfloat16, device=DEVICE)
    g = torch.Generator(device=DEVICE)
    g.manual_seed(SEED)
    for pool in cache["scan"].values():     # earlier context, unit scale
        pool.normal_(0.0, 1.0, generator=g)
    dev = torch.device(DEVICE)
    t32 = lambda a: torch.as_tensor(np.asarray(a, np.int32)).to(dev)
    cache.update(block_tables=t32(tables), token_pos=t32(pos + pad),
                 slot_mapping=t32(slots + pad), tile_meta=t32(tm.meta),
                 row_tile=t32(tm.row_tile))
    saved = {k: v.clone() for k, v in cache["scan"].items()}
    toks = t32(tokens + pad)
    logits_k, _ = api.ragged_step(params, cache, toks, tile=tile,
                                  use_kernel=True)
    for k, v in saved.items():
        cache["scan"][k].copy_(v)
    logits_p, _ = api.ragged_step(params, cache, toks, tile=tile,
                                  use_kernel=False)
    _sync()
    a, b = logits_k[:T], logits_p[:T]
    err = (a - b).abs().max().item()
    scale = b.abs().max().item()
    agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    finite = bool(torch.isfinite(a).all())
    print(f"step vs plain: T={T} logits {tuple(a.shape)} "
          f"max_abs_err={err:.4f} max_abs_logit={scale:.4f} "
          f"argmax_agreement={agree:.4f} (tol: err <= 0.05 * max_abs_logit,"
          f" agreement >= 0.9)", flush=True)
    if not finite or err > 0.05 * scale or agree < 0.9:
        raise AssertionError("full-width step disagrees with the plain "
                             "path")


def _sync() -> None:
    import torch
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on the card",
              file=sys.stderr)
        sys.exit(2)
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models.api import build_model

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"device: torch={torch.__version__} cuda={torch.version.cuda} "
          f"name={kind} count={torch.cuda.device_count()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    paths = _build.build(_build.sources())
    print(f"build: {sorted(paths)} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)})", flush=True)

    # 3. kernels against their plain versions
    checks = phase_kernel_checks()

    # 4. main path at full width
    cfg = get_config("gemma-7b")
    api = build_model(cfg)
    t0 = time.perf_counter()
    params = api.init(seed=SEED, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"init: gemma-7b {n_params / 1e9:.3f} B params bf16 in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card",
          flush=True)
    _, launches = phase_main_path(api, params)

    # 5. one full-width step against the plain path
    phase_step_vs_plain(api, params)

    main_cfg = checks["gemma-7b bf16"]
    print(json.dumps({"kernels": [{
        "name": pa.KERNEL,
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention_tiled.cu",
        "replaces": "src/repro/kernels/paged_attention.py:373",
        "launches": launches,
        "max_abs_err": main_cfg["max_abs_err"],
        "ms": main_cfg["ms"],
        "plain_ms": main_cfg["plain_ms"],
        "bound_ms": main_cfg["bound_ms"],
        "bound_by": main_cfg["bound_by"],
        "library_ms": main_cfg["library_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


if __name__ == "__main__":
    main()
