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
   main paths' shapes (gemma-7b bf16 and int8 pools, starcoder2-7b GQA
   with a sliding window): the segment-tiled read (B1) and the per-token
   read (B2) on one mixed flat stream, the rectangular read (B3) on the
   same segments as a (lanes, chunk) batch and as one decode call; each
   with its time, the plain version's, one PyTorch library call's and
   the least time the card could take;
4. the main paths: ``PagedDecodeEngine`` serving gemma-7b at its
   published width (all 28 layers, random bf16 weights from a seed) on
   requests that share a system prompt, three times from the same
   weights: with its defaults (segment-tiled), ``tiled=False``
   (per-token) and ``ragged=False`` (rectangular); on each, every step
   must have gone through that path's kernel (launches == layers x
   steps) and through no other attention kernel;
5. one full-width ``ragged_step`` (tiled and per-token) and one
   full-width ``paged_step``, each with the kernel against the same step
   on the plain path, on the same pools;
6. (run right after 3) the pseudo-Voigt fit (B7) against its plain
   version on the card, on the port's ``bragg_patches`` at the paper's
   800,000 peaks, at a ragged count and on all-zero patches, with its
   time, the plain version's and the least time the card could take (no
   single PyTorch call computes the fit, so it has no library time);
7. the paper's loop for BraggNN at the paper's scale, in float32: S
   simulates 800,000 training and 800,000 held-out patches, A labels the
   training set through B7 (``label_for_braggnn``), T trains BraggNN at
   its published width for 300 ``adam(1e-3)`` steps at batch 64, E
   estimates the held-out centers through ``BatchEngine``; the labels and
   the estimates must be near the ground truth.

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
F32_FLOPS = 67e12             # H100 SXM float32 peak outside the tensor cores
# the paper's peaks per experiment (src/repro/core/costmodel.py:32)
PAPER_PEAKS = 800_000
# B7 against its plain version, |kernel - plain| <= PV_TOL * (1 + |plain|):
# both run the same float32 arithmetic, summed in other orders and with
# fused multiply-adds in the kernel; on an H100 they differ by at most
# 1.5e-6 on the path's patches (PERF.md)
PV_TOL = 1e-5
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
    token_lane = np.zeros((T_pad,), np.int32)
    token_pos = np.zeros((T_pad,), np.int32)
    for lane, (start, n) in enumerate(segments):
        token_lane[offs[lane]:offs[lane] + n] = lane
        token_pos[offs[lane]:offs[lane] + n] = start + np.arange(n)
    token_tables = tables[token_lane]
    token_tables[T:] = 0           # padding tokens read the null block
    t32 = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return dict(q=q, k=k, v=v, scales=scales, tables=t32(tables),
                meta=t32(tm.meta), row_tile=t32(tm.row_tile), tile=tile,
                window=window, T=T, segments=segments, bs=bs, offs=offs,
                tables_np=tables, meta_np=tm.meta,
                token_tables=t32(token_tables), token_pos=t32(token_pos),
                token_tables_np=token_tables)


def _rect_batch(s):
    """The stream's segments as the rectangular step lays them out: q
    (lanes, C, H, D) with C the pow2 above the longest segment, q_starts
    and q_lens per lane; and the same lanes' next decode (one token at
    each lane's context end, q (lanes, H, D) and ctx_lens)."""
    import numpy as np
    import torch
    segs = s["segments"]
    q = s["q"]
    C = 1 << (max(n for _, n in segs) - 1).bit_length()
    B = len(segs)
    qr = torch.zeros((B, C) + tuple(q.shape[1:]), dtype=q.dtype,
                     device=q.device)
    for b, (start, n) in enumerate(segs):
        qr[b, :n] = q[s["offs"][b]:s["offs"][b] + n]
    dev = q.device
    t32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)
    starts = [st for st, _ in segs]
    lens = [n for _, n in segs]
    last = [s["offs"][b] + n - 1 for b, (_, n) in enumerate(segs)]
    return dict(q=qr, q_starts=t32(starts), q_lens=t32(lens),
                q_dec=q[last].contiguous(),
                ctx_lens=t32([st + n for st, n in segs]),
                dec_segments=[(st + n - 1, 1) for st, n in segs])


def _bound(s, segments, meta_bytes) -> tuple:
    """Least time for the work these segments need (segment ``lane`` of
    ``segments`` is (start, n) of that lane): each needed K/V block (and
    scale) read once, q read and the real rows written once, plus
    ``meta_bytes`` of metadata, over the memory rate; QK and PV FLOPs
    over the valid keys of every real row at the bf16 peak.  Returns
    (ms, bound_by)."""
    q, k = s["q"], s["k"]
    Hkv, D = k.shape[2], k.shape[3]
    H = q.shape[-2]
    bs, window = s["bs"], s["window"]
    needed = set()
    flops = 0
    rows = 0
    for lane, (start, n) in enumerate(segments):
        first_key = max(0, start - window + 1) if window else 0
        for j in range(first_key // bs, (start + n - 1) // bs + 1):
            needed.add(int(s["tables_np"][lane, j]))
        for p in range(start, start + n):
            keys = min(p + 1, window) if window else p + 1
            flops += 4 * D * keys * H
        rows += n
    elem = k.element_size()
    kv_bytes = len(needed) * bs * Hkv * (D * elem + (4 if s["scales"]
                                                     else 0)) * 2
    qo_bytes = 2 * rows * H * D * q.element_size()
    byte_ms = (kv_bytes + qo_bytes + meta_bytes) / HBM_BYTES_PER_S * 1e3
    flop_ms = flops / BF16_FLOPS * 1e3
    return (byte_ms, "bytes") if byte_ms >= flop_ms else (flop_ms,
                                                          "operations")


def _library_call(s, segs, q):
    """``scaled_dot_product_attention`` over the same work, one call:
    each segment's q rows (back to back in ``q``) against its lane's
    gathered span, padded to the longest segment and deepest span, with
    a causal/window mask.  Built once here; only the call is timed (a
    yardstick, never used by the port)."""
    import torch
    import torch.nn.functional as F
    k, v = s["k"], s["v"]
    Hkv, D = k.shape[2], k.shape[3]
    H = q.shape[1]
    bs = s["bs"]
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


def _check_kernel(label, kernel, plain, rows, tol, lib, bound):
    """Run ``kernel()`` and ``plain()`` once, compare ``rows(out)`` (the
    real rows), time the kernel, the plain version and ``lib``; print one
    line and return the numbers.  Raises on disagreement."""
    import torch
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    a, b = rows(got), rows(want)
    err = (a.float() - b.float()).abs().max().item()
    finite = bool(torch.isfinite(a).all())
    ms = _median_ms(kernel, reps=20)
    plain_ms = _median_ms(plain, reps=5)
    library_ms = _median_ms(lib, reps=10)
    bound_ms, bound_by = bound
    print(f"kernel check [{label}]: max_abs_err={err:.3e} (tol {tol:g}) "
          f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
          f"bound_ms={bound_ms:.4f} ({bound_by})", flush=True)
    if not finite or not err <= tol:
        raise AssertionError(f"kernel disagrees with its plain version "
                             f"[{label}]: max_abs_err={err} tol={tol} "
                             f"finite={finite}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)


def phase_kernel_checks():
    """B1, B2 and B3 against their plain versions at three
    configurations.  Returns {kernel: {config: numbers}}; raises if any
    disagrees."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref as kref
    configs = [
        # name, Hkv, G, D, pool dtype, window, tolerance on max |err|
        ("gemma-7b bf16", 16, 1, 256, torch.bfloat16, 0, 5e-2),
        ("gemma-7b int8", 16, 1, 256, torch.int8, 0, 5e-2),
        ("starcoder2-7b bf16 window", 4, 9, 128, torch.bfloat16, 256, 5e-2),
    ]
    results = {pa.TILED: {}, pa.RAGGED: {}, pa.ROWS: {},
               pa.ROWS + " decode": {}}
    for name, Hkv, G, D, pdt, window, tol in configs:
        s = _mixed_stream(Hkv=Hkv, G=G, D=D, bs=16, tile=16, pool_dtype=pdt,
                          window=window, seed=SEED)
        T, segs = s["T"], s["segments"]
        n_tiles = int((s["meta"][2] > s["meta"][1]).sum())
        print(f"kernel inputs [{name}]: T={T} (padded {s['q'].shape[0]}) "
              f"tiles={n_tiles}/{s['meta'].shape[1]} Hkv={Hkv} G={G} D={D} "
              f"bs=16 tile=16 window={window} pool={str(pdt)[6:]}",
              flush=True)
        sc = s["scales"]
        lib = _library_call(s, segs, s["q"][:T])
        real = lambda out: out[:T]

        # B1: segment-tiled read of the stream
        args = (s["q"], s["k"], s["v"], s["tables"], s["meta"],
                s["row_tile"])
        kw = dict(tile=s["tile"], window=window, **sc)
        results[pa.TILED][name] = _check_kernel(
            f"{pa.TILED} {name}",
            lambda: ops.paged_attention_ragged_tiled(*args, use_kernel=True,
                                                     **kw),
            lambda: ops.paged_attention_ragged_tiled(*args, use_kernel=False,
                                                     **kw),
            real, tol, lib,
            _bound(s, segs, s["tables_np"].nbytes + s["meta_np"].nbytes))

        # B2: per-token read of the same stream
        pargs = (s["q"], s["k"], s["v"], s["token_tables"], s["token_pos"])
        pkw = dict(window=window, **sc)
        results[pa.RAGGED][name] = _check_kernel(
            f"{pa.RAGGED} {name}",
            lambda: ops.paged_attention_ragged(*pargs, use_kernel=True,
                                               **pkw),
            lambda: ops.paged_attention_ragged(*pargs, use_kernel=False,
                                               **pkw),
            real, tol, lib,
            _bound(s, segs, s["token_tables_np"].nbytes
                   + s["token_pos"].numel() * 4))

        # B3: the same segments as a (lanes, chunk) batch, then one decode
        r = _rect_batch(s)
        C = r["q"].shape[1]
        rargs = (r["q"], s["k"], s["v"], s["tables"], r["q_starts"],
                 r["q_lens"])
        rreal = lambda out: torch.cat([out[b, :n] for b, (_, n)
                                       in enumerate(segs)])
        rect_meta = s["tables_np"].nbytes + 2 * 4 * len(segs)
        results[pa.ROWS][name] = _check_kernel(
            f"{pa.ROWS} chunk C={C} {name}",
            lambda: ops.paged_attention_chunk(*rargs, use_kernel=True,
                                              **pkw),
            lambda: ops.paged_attention_chunk(*rargs, use_kernel=False,
                                              **pkw),
            rreal, tol, lib, _bound(s, segs, rect_meta))
        dargs = (r["q_dec"], s["k"], s["v"], s["tables"], r["ctx_lens"])
        results[pa.ROWS + " decode"][name] = _check_kernel(
            f"{pa.ROWS} decode C=1 {name}",
            lambda: ops.paged_attention(*dargs, use_kernel=True, **pkw),
            lambda: ops.paged_attention(*dargs, use_kernel=False, **pkw),
            lambda out: out, tol,
            _library_call(s, r["dec_segments"], r["q_dec"]),
            _bound(s, r["dec_segments"], s["tables_np"].nbytes
                   + 4 * len(segs)))
        del s, r
        torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phase 4: the main paths at full width
# ---------------------------------------------------------------------------
# (label, engine options, the kernel that path's attention read launches)
PATHS = [("default (segment-tiled)", {}, "paged_attention_tiled"),
         ("tiled=False (per-token)", {"tiled": False},
          "paged_attention_ragged"),
         ("ragged=False (rectangular)", {"ragged": False},
          "paged_attention_rows")]


def phase_main_path(api, params, label, engine_kw, kernel):
    """Serve gemma-7b requests through the paged engine with
    ``engine_kw``; every step must launch ``kernel`` once per layer and
    no other attention kernel.  Returns that kernel's launches."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.profile_serve import serve_fleet
    cfg = api.cfg
    max_new = 32
    pa.reset_launch_counts()
    eng, finished, wall = serve_fleet(api, params, max_new=max_new,
                                      seed=SEED, device=DEVICE, **engine_kw)
    launches = dict(pa.launch_counts)
    s = eng.stats()
    print(f"main path [{label}]: gemma-7b full width (d_model={cfg.d_model}, "
          f"{cfg.n_heads}x{cfg.resolved_head_dim} heads, d_ff={cfg.d_ff}, "
          f"vocab={cfg.vocab_size}, layers={cfg.n_layers}) "
          f"requests={len(finished)} steps={eng.steps} "
          f"tokens={eng.tokens_decoded} prefilled={eng.tokens_prefilled} "
          f"wall_s={wall:.3f} tok_per_s={eng.tokens_decoded / wall:.2f} "
          f"ms_per_step={wall / eng.steps * 1e3:.2f} "
          f"padding_efficiency={s['padding_efficiency']:.4f} "
          f"kernel_launches={json.dumps(launches)}", flush=True)
    print(f"main path [{label}] stats: {json.dumps(s)}", flush=True)
    if len(finished) != 8:
        raise AssertionError(f"{len(finished)} of 8 requests finished")
    if not all(len(r.generated) == max_new for r in finished):
        raise AssertionError("a request finished without its tokens")
    want = {k: (cfg.n_layers * eng.steps if k == kernel else 0)
            for k in launches}
    if launches != want:
        raise AssertionError(f"[{label}] kernel launches {launches} != "
                             f"{want} (layers x steps on its own kernel)")
    if not (s["prefix_hits"] > 0 and s["cow_copies"] > 0
            and s["spec_verifications"] > 0):
        raise AssertionError(f"[{label}] prefix cache, CoW or speculation "
                             "did not run")
    return launches[kernel]


# ---------------------------------------------------------------------------
# phase 5: full-width steps, kernel against plain path
# ---------------------------------------------------------------------------
def phase_step_vs_plain(api, params):
    """One mixed batch through ``ragged_step`` (segment-tiled, then
    per-token) and through ``paged_step`` (the same segments as a
    rectangle), each with the kernel and on the plain path from the same
    pools; logits must agree."""
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
    tokens, pos, slots, token_lane = [], [], [], []
    offs, lens, lanes, pos0 = [], [], [], []
    for lane, (start, n) in enumerate(segments):
        for j in range(-(-(start + n) // bs)):
            tables[lane, j] = free.pop()
        offs.append(len(tokens)); lens.append(n); lanes.append(lane)
        pos0.append(start)
        for p in range(start, start + n):
            tokens.append(int(rng.integers(0, cfg.vocab_size)))
            pos.append(p)
            token_lane.append(lane)
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
    saved = {k: v.clone() for k, v in cache["scan"].items()}
    flat = dict(block_tables=t32(tables), token_pos=t32(pos + pad),
                slot_mapping=t32(slots + pad))
    tiled = dict(flat, tile_meta=t32(tm.meta), row_tile=t32(tm.row_tile))
    per_token = dict(flat, token_lane=t32(token_lane + pad))
    C = 1 << (max(lens) - 1).bit_length()
    rect_tokens = np.zeros((n_lanes, C), np.int32)
    for lane, (off, n) in enumerate(zip(offs, lens)):
        rect_tokens[lane, :n] = tokens[off:off + n]
    rect = dict(block_tables=t32(tables), pos=t32(pos0), q_lens=t32(lens))

    def real_rows(logits):
        if logits.dim() == 2:
            return logits[:T]
        return torch.cat([logits[b, :n] for b, n in enumerate(lens)])

    for label, meta, step, toks, kw in (
            ("ragged_step tiled", tiled, api.ragged_step,
             t32(tokens + pad), {"tile": tile}),
            ("ragged_step per-token", per_token, api.ragged_step,
             t32(tokens + pad), {}),
            (f"paged_step rectangular C={C}", rect, api.paged_step,
             t32(rect_tokens), {})):
        out = {}
        for use_kernel in (True, False):
            for k, v in saved.items():
                cache["scan"][k].copy_(v)
            cache.update(meta)
            logits, _ = step(params, cache, toks, use_kernel=use_kernel,
                             **kw)
            out[use_kernel] = real_rows(logits)
            for k in ("tile_meta", "row_tile", "token_lane", "token_pos",
                      "slot_mapping", "q_lens"):
                cache.pop(k, None)
        _sync()
        a, b = out[True], out[False]
        err = (a - b).abs().max().item()
        scale = b.abs().max().item()
        agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
        finite = bool(torch.isfinite(a).all())
        print(f"step vs plain [{label}]: T={T} logits {tuple(a.shape)} "
              f"max_abs_err={err:.4f} max_abs_logit={scale:.4f} "
              f"argmax_agreement={agree:.4f} (tol: err <= 0.05 * "
              f"max_abs_logit, agreement >= 0.9)", flush=True)
        if not finite or err > 0.05 * scale or agree < 0.9:
            raise AssertionError(f"full-width {label} disagrees with the "
                                 "plain path")
        del out, a, b
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 6: the pseudo-Voigt fit against its plain version
# ---------------------------------------------------------------------------
def _pv_ops(ph: int, pw: int, n_iter: int) -> int:
    """Float operations of one patch's fit, counted from the arithmetic of
    ``ref.pv_fit_1d`` (each add, multiply, divide, compare, exp and sqrt
    is one): the two marginals, then per profile of n points ~9n + 5 to
    start, and per Gauss-Newton step 52 per point (profile, derivatives,
    residual and the nine sums) plus ~70 to form and solve the 3x3
    system."""
    def fit(n):
        return 9 * n + 5 + n_iter * (52 * n + 70)
    return 2 * ph * pw + fit(ph) + fit(pw)


def _pv_bound(p, n_iter: int) -> tuple:
    """Least time for the fit of patches ``p`` (Np, ph, pw): every patch
    read once and the (Np, 6) fits written once at the memory rate,
    against the float operations at the float32 peak.  Returns
    (ms, bound_by, byte_ms, op_ms)."""
    Np, ph, pw = p.shape
    byte_ms = Np * (ph * pw + 6) * 4 / HBM_BYTES_PER_S * 1e3
    op_ms = Np * _pv_ops(ph, pw, n_iter) / F32_FLOPS * 1e3
    if byte_ms >= op_ms:
        return byte_ms, "bytes", byte_ms, op_ms
    return op_ms, "operations", byte_ms, op_ms


def phase_pv_kernel():
    """B7 against its plain version on the port's ``bragg_patches`` at
    the paper's 800,000 peaks, at a ragged count and on all-zero patches.
    Returns the numbers at 800,000; raises on any disagreement."""
    import torch
    from repro_torch.data.synthetic import bragg_patches
    from repro_torch.kernels import ops
    g = torch.Generator(device=DEVICE)
    g.manual_seed(SEED)
    cases = [
        (f"Np={PAPER_PEAKS} 11x11", lambda: bragg_patches(
            g, PAPER_PEAKS, device=DEVICE)["patches"][..., 0]),
        ("ragged Np=1000003 11x11", lambda: bragg_patches(
            g, 1_000_003, device=DEVICE)["patches"][..., 0]),
        ("all-zero Np=8 11x11", lambda: torch.zeros((8, 11, 11),
                                                    device=DEVICE)),
    ]
    results = {}
    for label, make in cases:
        p = make().contiguous()
        got = ops.pseudo_voigt_fit(p, use_kernel=True)
        want = ops.pseudo_voigt_fit(p, use_kernel=False)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        col_err = diff.amax(dim=0).tolist()
        err = max(col_err)
        over = int((diff > PV_TOL * (1 + want.abs())).sum())
        finite = bool(torch.isfinite(got).all())
        ms = _median_ms(lambda: ops.pseudo_voigt_fit(p, use_kernel=True),
                        reps=20)
        plain_ms = _median_ms(
            lambda: ops.pseudo_voigt_fit(p, use_kernel=False), reps=5,
            inner=3)
        bound_ms, bound_by, byte_ms, op_ms = _pv_bound(p, 5)
        print(f"kernel check [pseudo_voigt {label}]: max_abs_err per column "
              f"(y0, x0, gy, gx, Ay, Ax)="
              f"{', '.join(f'{e:.3e}' for e in col_err)} "
              f"(tol |err| <= {PV_TOL:g} * (1 + |plain|), {over} over) "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} "
              f"({bound_by}; bytes {byte_ms:.4f}, operations {op_ms:.4f}) "
              f"library: none", flush=True)
        if label.startswith("all-zero"):
            fit0 = ", ".join(f"{v:.6g}" for v in got[0].tolist())
            print(f"kernel check [pseudo_voigt {label}]: fit of a zero patch "
                  f"({fit0})", flush=True)
        if not finite or over:
            raise AssertionError(f"pseudo_voigt disagrees with its plain "
                                 f"version [{label}]: {over} values over "
                                 f"tolerance, finite={finite}")
        results[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              library_ms=None, bound_ms=bound_ms,
                              bound_by=bound_by)
        del p, got, want, diff
    torch.cuda.empty_cache()
    return results[cases[0][0]]


# ---------------------------------------------------------------------------
# phase 7: the paper's S -> A -> T -> E loop for BraggNN
# ---------------------------------------------------------------------------
def phase_paper_loop():
    """S, A, T and E at the paper's scale on the card, in float32; the
    counts of B7 are zeroed just before and read just after.  Returns
    B7's launches; raises if a check fails."""
    import numpy as np
    import torch
    from repro_torch.analysis import label_for_braggnn
    from repro_torch.configs import BraggNNConfig
    from repro_torch.data.synthetic import bragg_patches
    from repro_torch.kernels import pseudo_voigt as pv
    from repro_torch.models import braggnn
    from repro_torch.optim import adam
    from repro_torch.serving.batch import BatchEngine
    from repro_torch.train import TrainerConfig, fit
    print(f"paper loop: float32, torch.backends.cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32} "
          f"torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}", flush=True)
    cfg = BraggNNConfig()
    n = PAPER_PEAKS
    px = cfg.patch - 1
    pv.reset_launch_counts()

    # S: simulate the training and the held-out experiment
    t0 = time.perf_counter()
    g = torch.Generator(device=DEVICE)
    g.manual_seed(SEED + 7)
    train = bragg_patches(g, n, cfg.patch, device=DEVICE)
    held = bragg_patches(g, n, cfg.patch, device=DEVICE)
    _sync()
    s_sec = time.perf_counter() - t0

    # A: label the training set with the conventional fit (B7)
    t0 = time.perf_counter()
    labels = label_for_braggnn(train["patches"])
    _sync()
    a_sec = time.perf_counter() - t0
    a_launches = pv.launch_counts[pv.PV]
    label_err = float((labels - train["centers"]).abs().mean())
    print(f"paper loop A: {n} peaks labelled in {a_sec:.4f} s "
          f"({n / a_sec:.4e} peaks/s), pseudo_voigt launches={a_launches}, "
          f"mean |label - truth|={label_err:.5f} (limit 0.05, "
          f"{label_err * px:.4f} px)", flush=True)
    if label_err >= 0.05:
        raise AssertionError(f"labels are {label_err} from the truth")

    # T: train BraggNN at its published width on the labelled set,
    # consecutive batches as examples/remote_retrain_flow.py takes them
    params = braggnn.init_params(cfg, seed=SEED, device=DEVICE)
    bs, steps = 64, 300

    def batches():
        for i in range(steps):
            lo = (i * bs) % (n - bs)
            yield {"patches": train["patches"][lo:lo + bs],
                   "centers": labels[lo:lo + bs]}

    t0 = time.perf_counter()
    state, hist = fit(lambda p, b: braggnn.loss_fn(p, b, cfg), adam(1e-3),
                      params, batches(),
                      TrainerConfig(steps=steps, log_every=150))
    _sync()
    t_sec = time.perf_counter() - t0
    losses = dict(hist["loss"])
    print(f"paper loop T: BraggNN (base {cfg.base_channels} channels, FC "
          f"{'-'.join(map(str, cfg.fcsz))}, "
          f"{sum(v.numel() for v in params.values())} params) {steps} "
          f"adam(1e-3) steps at batch {bs} in {t_sec:.4f} s "
          f"({t_sec / steps * 1e3:.4f} ms/step); loss at step 1 "
          f"{losses[1]:.6f}, 150 {losses[150]:.6f}, 300 {losses[300]:.6f}",
          flush=True)
    if not all(np.isfinite(v) for v in losses.values()):
        raise AssertionError(f"training loss not finite: {losses}")

    # E: estimate the held-out centers through the edge batch engine
    x = held["patches"].cpu().numpy()
    truth = held["centers"].cpu().numpy()
    eng = BatchEngine(lambda p, xb: braggnn.forward(p, xb, cfg),
                      state.params, max_batch=1024, device=DEVICE)
    t0 = time.perf_counter()
    pred = eng.infer(x)
    e_sec = time.perf_counter() - t0
    err_px = float(np.abs(pred - truth).mean()) * px
    print(f"paper loop E: {n} held-out peaks in {e_sec:.4f} s "
          f"({n / e_sec:.4e} peaks/s), stats={json.dumps(eng.stats.summary())}"
          f", mean |err| vs truth={err_px:.4f} px (limit 0.5)", flush=True)
    if pred.shape != (n, 2) or not np.isfinite(pred).all():
        raise AssertionError(f"estimates {pred.shape} not finite (n, 2)")
    if not err_px < 0.5:
        raise AssertionError(f"surrogate error {err_px} px >= 0.5")
    launches = pv.launch_counts[pv.PV]
    total = s_sec + a_sec + t_sec + e_sec
    print(f"paper loop: S={s_sec:.4f} s A={a_sec:.4f} s T={t_sec:.4f} s "
          f"E={e_sec:.4f} s turnaround S+A+T+E={total:.4f} s; pseudo_voigt "
          f"launches over the loop={launches}", flush=True)
    if launches < 1:
        raise AssertionError("the paper loop never launched pseudo_voigt")
    return launches


def _sync() -> None:
    import torch
    if DEVICE == "cuda":
        torch.cuda.synchronize()


# each kernel (csrc/<name>.cu) and the TPU kernel it replaces
KERNELS = [("paged_attention_tiled", "paged_attention.py:373"),
           ("paged_attention_ragged", "paged_attention.py:242"),
           ("paged_attention_rows", "paged_attention.py:109"),
           ("pseudo_voigt", "pseudo_voigt.py:81")]


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on the card",
              file=sys.stderr)
        sys.exit(2)
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
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
    # 6. B7 against its plain version (before the gemma-7b weights take
    # the card)
    pv_check = phase_pv_kernel()

    # 4. main paths at full width, one set of weights
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
    launches = {kernel: phase_main_path(api, params, label, kw, kernel)
                for label, kw, kernel in PATHS}

    # 5. full-width steps against the plain path
    phase_step_vs_plain(api, params)
    del params
    torch.cuda.empty_cache()

    # 7. the paper's loop
    launches["pseudo_voigt"] = phase_paper_loop()

    # each kernel's numbers at its main path's shapes
    numbers = {name: c["gemma-7b bf16"] for name, c in checks.items()}
    numbers["pseudo_voigt"] = pv_check
    rows = []
    for name, replaces in KERNELS:
        main_cfg = numbers[name]
        rows.append({
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": launches[name],
            "max_abs_err": main_cfg["max_abs_err"],
            "ms": main_cfg["ms"],
            "plain_ms": main_cfg["plain_ms"],
            "bound_ms": main_cfg["bound_ms"],
            "bound_by": main_cfg["bound_by"],
            "library_ms": main_cfg["library_ms"],
        })
    print(json.dumps({"kernels": rows}), flush=True)
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
