"""Serving launcher of the port:
``python -m repro_torch.launch.serve --arch gemma-7b [--full] [--device cuda|cpu]``.

Builds the port's DecodeEngine (the paged engine with its defaults for
the dense and MoE families and the VLM's text backbone, e.g. ``--arch
gemma-7b``, ``deepseek-moe-16b``, ``llava-next-mistral-7b`` or
``command-r-35b``; the dense-slot engine for the recurrent families,
``--arch zamba2-2.7b`` and ``--arch xlstm-1.3b``, and the audio
encoder-decoder, ``--arch whisper-base``, whose decoder is served with
the cache's cross K/V at zero, as the reference's engine serves it) on
the smoke variant of the arch, or at its published width with ``--full``,
with random bf16 weights from seed 0, and serves a batch of synthetic
requests.  It runs on the CUDA card unless ``--device cpu`` is given.

``--mesh-shape dp,tp`` serves over a mesh of dp x tp positions: dp
data-parallel slices (``ShardedDecodeEngine``) of tp tensor-parallel
shards each; ``--tp N`` runs N-way tensor parallelism over every visible
card.  On the card the positions are the first dp x tp cards; with
``--device cpu`` they are dp x tp CPU positions, which run every shard's
layers and reduces on the CPU:

    python -m repro_torch.launch.serve --arch gemma-7b --device cpu \
        --mesh-shape 2,2
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.launch.mesh import build_mesh
from repro_torch.models.api import build_model
from repro_torch.serving.engine import DecodeEngine

_CACHE_DTYPES = {"auto": None, "bf16": torch.bfloat16, "f32": torch.float32,
                 "int8": torch.int8}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--full", action="store_true",
                    help="the arch at its published width (default: its "
                         "smoke variant)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--cache-dtype", default="auto",
                    choices=sorted(_CACHE_DTYPES),
                    help="KV pool dtype (auto = the compute dtype; int8 = "
                         "quantized pools with per-slot scales)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--block-size", type=int, default=16,
                    help="tokens per physical KV block (paged engine)")
    ap.add_argument("--num-blocks", type=int, default=0,
                    help="physical KV pool size; 0 = dense-equivalent")
    ap.add_argument("--token-budget", type=int, default=0,
                    help="max tokens per engine step; "
                         "0 = slots * chunk-tokens")
    ap.add_argument("--chunk-tokens", type=int, default=16,
                    help="max prefill tokens per request per step")
    ap.add_argument("--prefix-cache", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="share identical prompt prefixes copy-on-write")
    ap.add_argument("--ragged", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="flat-token serving batch (one 1-D stream of all "
                         "scheduled tokens per step); --no-ragged pins the "
                         "rectangular (lanes, chunk_width) layout")
    ap.add_argument("--tiled", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="segment-tiled attention grid over the flat "
                         "stream (KV read once per q-tile); --no-tiled "
                         "pins the per-token (token, head, block) grid")
    ap.add_argument("--tile", type=int, default=16,
                    help="q rows per segment tile window (pow2)")
    ap.add_argument("--spec", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="speculative multi-token decode with n-gram drafts")
    ap.add_argument("--draft-k", type=int, default=4,
                    help="max draft tokens per decode lane per step")
    ap.add_argument("--slo-ttft-ms", type=float, default=0.0,
                    help="time-to-first-token target (ms); 0 disables")
    ap.add_argument("--slo-tpot-ms", type=float, default=0.0,
                    help="time-per-output-token target (ms); 0 disables")
    ap.add_argument("--engine", choices=["auto", "paged", "slot"],
                    default="auto",
                    help="paged block-pool engine vs dense-slot reference")
    ap.add_argument("--mesh-shape", default="",
                    help='"dp,tp" mesh: dp data-parallel engine slices x '
                         "tp-way tensor-parallel shards each")
    ap.add_argument("--tp", type=int, default=0,
                    help="tensor-parallel degree over every visible card "
                         "(dp = cards / tp)")
    args = ap.parse_args(argv)
    if args.mesh_shape and args.tp:
        raise SystemExit("--mesh-shape and --tp are exclusive")
    mesh = build_mesh(args.mesh_shape, args.tp, args.device)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.smoke_variant()
    api = build_model(cfg)
    params = api.init(seed=0, device=args.device, dtype=torch.bfloat16)

    window = api.effective_window(args.cache_len)
    paged = None if args.engine == "auto" else (args.engine == "paged")
    kw = {"device": args.device,
          "cache_dtype": _CACHE_DTYPES[args.cache_dtype]}
    if paged is not False and api.supports_paged:
        kw.update(block_size=args.block_size,
                  num_blocks=args.num_blocks or None,
                  token_budget=args.token_budget,
                  chunk_tokens=args.chunk_tokens,
                  prefix_cache=args.prefix_cache,
                  ragged=args.ragged and api.supports_ragged,
                  tiled=(args.tiled and args.ragged
                         and api.supports_ragged),
                  tile=args.tile,
                  spec=args.spec and api.supports_spec,
                  draft_k=args.draft_k,
                  ttft_target=args.slo_ttft_ms / 1e3,
                  tpot_target=args.slo_tpot_ms / 1e3)
    if mesh is not None:
        kw["mesh"] = mesh
    eng = DecodeEngine(api, params, paged=paged, n_slots=args.slots,
                       cache_len=args.cache_len, window=window, **kw)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for _ in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size,
                              size=args.prompt_len).astype(np.int32)
        eng.submit(prompt, args.max_new)
    finished = eng.run_until_drained()
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    dt = time.perf_counter() - t0
    shed = sum(1 for r in finished if getattr(r, "shed", False))
    print(f"arch={cfg.name} device={eng.device} "
          f"engine={type(eng).__name__} requests={len(finished)} "
          f"shed={shed} engine_steps={eng.steps} "
          f"tokens={eng.tokens_decoded} "
          f"({eng.tokens_decoded / dt:.1f} tok/s incl. kernel build)")
    print(f"  stats: {eng.stats()}")
    for r in finished[:3]:
        print(f"  req {r.request_id}: {len(r.generated)} tokens, "
              f"first 8 = {r.generated[:8]}")
    assert all(len(r.generated) > 0 for r in finished
               if not getattr(r, "shed", False))
    print("done")


if __name__ == "__main__":
    main()
