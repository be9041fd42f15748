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
   with a sliding window, and phase 10's: deepseek-moe-16b at D 128,
   G 1, command-r-35b at G 8, llava-next-mistral-7b's backbone at G 4
   with its 4096-token window, and phase 14's shards of gemma-7b's
   pools: 8 kv heads at TP 2 in bf16 and int8, 4 at TP 4): the
   segment-tiled read (B1) and the
   per-token read (B2) on one mixed flat stream, the rectangular read
   (B3) on the same segments as a (lanes, chunk) batch and as one decode
   call; each with its time, the plain version's, one PyTorch library
   call's and the least time the card could take; B1, B2 and B3 take
   bf16 q with bf16 or int8 pools through the tensor-core split sweep
   (the phase counts the ``HMMA`` instructions ``cuobjdump -sass`` finds
   in their libraries and fails on none, and prints B2's per-token
   bytes, the bytes its reads must move, beside its bound), and their
   float32 FMA kernels are checked and timed once on float32 copies of
   the gemma-7b stream;
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
   800,000 peaks, at a ragged count and on all-zero patches (all 11 x 11,
   the kernel's own instantiation; the card tests hold its other one),
   with its time, the plain version's and the least time the card could
   take (no single PyTorch call computes the fit, so it has no library
   time), and at 800,000 once more with no Gauss-Newton step (the fit's
   share);
7. the paper's loop for BraggNN at the paper's scale, in float32: S
   simulates 800,000 training and 800,000 held-out patches, A labels the
   training set through B7 (``label_for_braggnn``), T trains BraggNN at
   its published width for 300 ``adam(1e-3)`` steps at batch 64, E
   estimates the held-out centers through ``BatchEngine``; the labels and
   the estimates must be near the ground truth;
8. LM training through the flash-attention kernels: (a) the forward (B6),
   the forward with logsumexp (B6f) and the backward (B6b: dq, dk/dv)
   against their plain versions on the card, from float32 and from
   bfloat16 copies of the same inputs, at gemma-7b's training shape
   (S 4096, 16 x 256 heads) and at starcoder2-7b's heads with its sliding
   window (S 8192, 36 q and 4 kv heads x 128, window 4096), and at
   phase 13's training shapes, whisper-base's decoder (B 8, 8 x 64 heads,
   S 448) and zamba2-2.7b's shared attention (32 x 80 heads, S 2048),
   and at phase 15's TP 2 shards, gemma-7b's 8 x 256 heads at S 4096 and
   deepseek-moe-16b's 8 x 128 at S 2048, and at phase 16a's, llava's 16
   q and 4 kv heads x 128 at S 4096 with its 4096-token window, each with
   its
   time, the plain version's, ``scaled_dot_product_attention``'s and the
   least time the card could take, and its achieved TFLOP/s and share of
   that bound; bfloat16 runs the tensor-core kernels (wgmma fed by TMA:
   the phase counts the ``HGMMA`` instructions ``cuobjdump -sass`` finds in
   each of their libraries and fails on none), float32 the FMA kernels,
   which are timed too; (b) gemma-7b at its published width,
   depth cut to 4 of 28 layers (float32 AdamW state for 28 does not fit
   80 GB), float32 masters and bfloat16 compute, trained 10
   ``make_train_step_fn`` steps on ``TRAIN_4K``'s sequence at batch 1:
   every step must launch B6f 2 x L times (forward and the checkpointed
   recompute), dq and dk/dv L times each and no other attention kernel;
   the loss must fall; the plain path's step (``use_kernel=False``) from
   the first step's state and batch must agree with the kernel's in bf16,
   and on the last step's state the two paths must agree in float32; one
   no-grad eval forward must launch B6 L times;
9. the recurrent families: (a) the Mamba2 SSD scan (B5) at zamba2-2.7b's
   shapes (80 heads, P = N = 64, chunk 128) and the chunkwise mLSTM (B4)
   at xlstm-1.3b's (4 heads of 1024, chunk 128), each at 4096 tokens and
   at one sequence shorter than a chunk, from float32 inputs and their
   bf16 copies, against their plain versions on the card, with the time,
   the plain version's and the least time the card could take (no
   PyTorch call computes either scan, so no library time); bf16 inputs
   run each scan's tensor-core kernels (the phase counts the ``HMMA``
   instructions of B5's library and fails on none, and the ``HMMA`` and
   ``HGMMA`` of B4's and fails on none of either), float32 ones their
   FMA kernels, whose times are printed too, and B5 once more on as many
   heads as give one CTA a SM; and B6 at
   zamba2-2.7b's head dim 80 with SDPA's time; (b) zamba2-2.7b at its
   published width and depth (54 Mamba2 layers and the shared attention
   block, random bf16 weights from a seed): the prefill step
   (``make_prefill_step_fn``, no grad) at batch 1 x 4096 tokens must
   launch B5 54 times and the B6 forward 9 times and no other kernel, and
   agree with the plain path (``use_kernel=False``) in bf16 and in
   float32; one more kernel prefill runs under ``torch.profiler`` and
   prints its device time by kernel family (SSD scan, flash attention,
   GEMMs, the rest) and its idle share; then ``SlotDecodeEngine`` serves
   3 requests on 2 slots, every request to its end; (c) xlstm-1.3b
   likewise (48 layers; B4 42 times; not profiled: its sLSTM loop
   launches ~370,000 kernels a prefill);
10. the MoE family, the VLM backbone and command-r-35b on the paged
   path, at their published widths with random bf16 weights from a seed:
   (a) deepseek-moe-16b (28 layers: 1 dense, 27 of 64 routed experts,
   top-6 + 2 shared) serves phase 4's fleet in the three layouts with
   the engine's own proposer, each through its own paged read only
   (layers x steps), and after each fleet two requests are drained
   without drafts and then with drafts replaying those greedy tokens,
   which must be verified and in part accepted, through the same read
   only; (b) its mixed batch of phase 5, kernel against plain path, in
   bf16 at full depth and in float32 cut to 4 layers: the plain run
   takes the kernel run's routes (by wrapping the router's top-k,
   ``moe.route_topk``, for the phase) with its own gate values; the
   logits of every row are held within phase 5's gate in float32 and as
   a relative 2-norm in bf16, and the share of (token, MoE layer) whose
   own top-k on the plain path differs is gated; (c)
   llava-next-mistral-7b's image prefill (``make_prefill_step_fn`` on
   2880 seeded patch embeddings + 1216 tokens, window 4096) must launch
   B6 once a layer and no other kernel and agree with the plain path in
   bf16 and float32, then one default-layout fleet through the text
   backbone (B1 only); (d) command-r-35b (40 layers, G 8, parallel block,
   layernorm, tied 256,000-token vocab) serves one default-layout fleet
   (B1 only); (c) and (d) drain the speculation requests of (a) too.
   Each part prints its wall time and peak memory;
11. the data-center/edge bridge, each line tagged with the card's name and
   power limit: (a) the paper's DNNTrainerFlow on the port's
   ``repro_torch.core`` (``launch/remote_retrain_flow.run``) at the
   paper's scale: BraggNN at its published width on PAPER_PEAKS patches
   collected at the edge, TransferData, LabelData (B7), TrainModel (300
   ``adam(1e-3)`` steps at batch 64), TransferModel, RegisterModel as v1,
   then v2 warm-started from the repository (100 steps), then A||T over 8
   shards, then E on PAPER_PEAKS held-out patches: every run must succeed,
   B7 must launch in each LabelData and exactly 8 times over A||T and
   nowhere else, the labels and E must pass phase 7's gates, and the
   repository must hold v1 and v2; each state's charged seconds, the
   clock's split, A||T's saving and the cost model's strategies at
   PAPER_PEAKS are printed; (b) gemma-7b at full width and depth in bf16:
   one set of weights serves a "dc" and an "edge" ``PagedDecodeEngine``
   (phase 4's shape and fleet) through ``DisaggregatedEngine``, a
   one-engine run of the same fleet being the baseline: each engine must
   launch B1 layers x its steps and nothing else, every imported block
   must hold the exported block's bytes bit for bit, and the shared system
   prompt must cross once; the handoff check is off in bf16 and the
   agreement with the one-engine run is gated instead; the coordinator's
   stats, the turnaround priced at 1.25 and 12.5 GB/s and the crossover
   bandwidth are printed; (c) the same in float32 with the depth cut to
   DIS_F32_LAYERS layers, the handoff check on and every token the
   one-engine run's; (d) the edge engine's prefix-cache snapshot loaded
   by a fresh engine, whose warm prompt must hit the cache with the
   one-engine tokens, and an int8-pool shipment round trip (k, v and
   their scales), bit for bit;
12. the paper's second DNN, the online frontend and the crossover
   analysis, each line tagged with the card's name and power limit: (a)
   CookieNetAE through the paper's Table-1 flow
   (``launch/remote_retrain_flow.run_cookienetae``) in float32, TF32 off:
   COOKIE_SHOTS CookieBox shots simulated on the card (the reference's
   3.2 GB dataset) and collected at the edge as 10 files, TransferData,
   TrainModel (CookieNetAE at its published width, 300 ``adam(1e-3)``
   steps at batch 64), TransferModel (1.4 MB), RegisterModel as v1: the
   run must succeed, the repository hold v1, the last loss be at most 0.8
   of the first, the MSE on COOKIE_HELD held-out shots be below the
   untrained model's, and the trained forward on the card match the CPU's
   (relative 2-norm 1e-5); each state's charged seconds, the clock's
   split, T's ms a step, S's shots/s and the forward's ms a batch of 64
   are printed; (b) ``serving/frontend.py`` on phase 11's gemma-7b
   weights and fleet: 11b's one-engine drain gives the wall W and the
   capacity C = 8 / W; ``run_open_loop`` on a SimClock with the fleet
   arriving at seeded exponential gaps at FE_LOAD C (every request ok,
   goodput 1.0, tokens as the drain's within 11b's bf16 agreement
   limits); the fleet at t = 0 on one lane with a TTFT target of
   FE_OVERLOAD_TTFT and the first request cancelled by the harness (shed
   and cancels balance the books, nothing left on the engine); 8
   ``AsyncEngine.stream`` consumers in one asyncio loop, one of which
   disconnects after FE_DISCONNECT_AFTER tokens (one cancel, the
   survivors' streams equal their requests' tokens, the disconnected one
   a prefix of its own, no block left); ``bench_serving``'s leak probe at
   full width (every tier empty); every run through B1 only, layers x
   steps; then on 11c's float32 weights (DIS_F32_LAYERS layers) the
   light load and the streams, token-identical to 11c's drain; offered
   and goodput rps, TTFT p50/p95 (virtual s), makespan, steps, wall and
   peak memory are printed; (c) ``launch/crossover_analysis.run`` on the
   card: its three tables, and stage 2's split token-identical to one
   engine;
13. the audio family and the recurrent families' training, each line
   tagged with the card's name and power limit: (a) whisper-base at its
   published width (6 + 6 layers, d 512, 8 x 64 heads, vocab 51,865),
   seed-0 weights: 10 ``make_train_step_fn`` steps (float32 masters, bf16
   compute) at batch 8 x (1500 frame embeddings, 448 tokens), each
   launching B6f 2L times and dq, dk/dv L times (L = 6 decoder layers;
   the encoder's and the cross attention are plain PyTorch, as in the
   reference) and nothing else, the plain path's first step against the
   kernel's in bf16 and the two paths on the trained state in float32;
   ``make_prefill_step_fn`` at batch 4 (B6 L times), kernel against
   plain logits in bf16 and float32; 32 float32 decode steps with the
   cross K/V filled from ``encode`` -> ``encoder_kv`` against the
   forward's logits; ``SlotDecodeEngine`` serving 8 requests x 32 tokens
   on 4 slots (no kernel: decode attention is plain); (b) zamba2-2.7b at
   its published width, depth cut to the deepest whole number of 6-layer
   segments whose reckoned footprint (33 B a parameter, phase 8b's, plus
   AdamW's temporaries on the largest leaf) fits the card, trained 5
   steps at batch 1 x 2048: B6f twice and dq, dk/dv once per shared
   attention application a step (D 80), no B5 (the loss runs the scans'
   plain chunkwise forms); (c) xlstm-1.3b likewise in 8-layer segments,
   3 steps at batch 1 x 512, no kernel at all (no B4).  Each training
   run repeats one batch, whose loss must fall, and prints its ms a step,
   tokens/s and peak memory;
14. mesh serving, each line tagged with the card's name and power limit:
   gemma-7b at its published width (phase 4's weights and fleet) through
   ``PagedDecodeEngine(mesh=)`` on mesh positions that all name the one
   card (printed, with each run's reckoned GiB of shard copies and pools
   before it is built): (a) tp 1, TP 2 and TP 4 in the default layout,
   each launching B1 layers x tp x steps and no other paged read, with
   the prefix cache, CoW and speculation run and 2 L + 2 collectives a
   step (the step design's count), bf16 greedy agreement with tp 1
   printed; (b) TP 2 with ``tiled=False`` (B2) and ``ragged=False``
   (B3) on the shards' shapes, and with int8 pools, each gated as (a);
   (c) in each of those four layouts the fleet's first step's bf16
   logits, TP 2 against tp 1 in the same layout, within
   MESH_BF16_REL_L2 (relative 2-norm); (e) ``ShardedDecodeEngine`` on
   (2, 1) and (2, 2) meshes: every request finishes, B1 runs layers x tp
   x the slices' steps summed, the per-slice lists sum to the totals and
   both slices decode; (d, e) in float32 cut to MESH_F32_LAYERS
   layers, the TP 2, TP 4 and both DP fleets' tokens equal the tp 1
   engine's.  Where ``torch.cuda.device_count() >= 2``, (a)'s TP 2 fleet
   runs again on two cards (gated as (a)) and in float32 (tokens equal
   tp 1's); on one card a line says it did not run;
15. sharded training (``make_train_step_fn(mesh=)`` on
   ``sharding.place``'s float32 pieces), on mesh positions that all name
   the one card, each line tagged with the card's name and power limit:
   (a) gemma-7b at its published width, phase 8b's 4 layers, seed state
   and first batch (1 x 4096), TP 2; (b) the same on DP 2 x TP 2 with
   ``pre_gather`` at 2 x 2048; (c) deepseek-moe-16b at its published
   width (32 of 64 experts a position), its dense first layer and 2 MoE
   layers, TP 2 at 1 x 2048, ``impl="gshard"``.  Each trains a few bf16
   steps on one batch, whose loss must fall; every step must launch B6f
   2 x L, dq and dk/dv L times per position and no B6, and count the
   step design's collectives (the forward's reduces and gathers, their
   backward duals and the layers' again under remat); its first step's
   loss and gradient norm against the one-position step's from the same
   state within SHARD_BF16_*; and one float32 step from that state
   (without ``pre_gather``) against the one-position float32 step within
   SHARD_F32_RTOL: loss, gradient norm, the MoE aux, and every leaf's
   post-AdamW parameters and first moment as relative 2-norms (the
   elements within SHARD_EPS_SPAN eps of a zero gradient within 2 lr), (c)'s
   float32 run routed as the one position's (``_RoutePin``) and its own
   top-k sets that differ from them counted.  Walls, tokens/s, launches,
   collectives and peak memory are printed;
16. sharded training of the other families, gated as phase 15, on
   positions that all name the one card: (a) llava-next-mistral-7b at
   its published width, phase 8b's 4 of 32 layers, TP 2 (the projector
   cut over "model"), batch 1 x (2880 seeded patch embeddings + 1216
   tokens), 6 L + 4 + 2 collectives a step; then, in the gathered regime
   (every position gathers the whole tree, the rows cut over all
   positions; the gathers and their duals printed): (b) whisper-base
   whole on DP 2 x TP 2 at phase 13a's 8 x (1500 frames, 448 tokens);
   (c) zamba2-2.7b at its published width, 2 of 9 segments (12 Mamba2
   layers), on (1, 2) at 2 x 2048; (d) xlstm-1.3b, 1 of 6 segments (8
   layers), on (2, 2) under ``fsdp_flat`` with ``pre_gather`` at 4 x 256.
   Launches a position a step: B6f twice and dq, dk/dv once per
   attention application (L for (a), whisper's 6 decoder layers, zamba2's
   2 shared-block applications; no B5, and none at all in (d)).  The
   gathered runs' float32 reference is the one position summing the
   same row shares (the rows' order of sums, batched against shares, is
   printed).  Where
   ``torch.cuda.device_count() >= 2``, (a) runs again on two cards; on
   one card a line says it did not run;
17. the measured steps against their roofline bound: (a) (run right
   after 5, on phase 4's weights) the parameter count of the arch's tree
   on the ``meta`` device (``launch/dryrun.count_params``) must equal the
   card's tree exactly; gemma-7b's prefill step at 1 x FULL_PREFILL
   tokens (no grad) must launch B6 once a layer and nothing else, and is
   timed, as is its serve step at batch FULL_DECODE[0] over a
   FULL_DECODE[1]-slot cache (the dense slot step, which must launch no
   kernel); then each step of (a) and the medians that phases 8b, 9
   and 13a measured print their ``InputShape`` and depth,
   ``roofline/analytic.py``'s FLOPs and bytes, the H100 roofline terms
   (``roofline/analysis.RooflineTerms``, one card), the measured time,
   the bound share (the least time over the measured time, which must
   lie in (0, ROOFLINE_SHARE_MAX]) and the model-FLOP share.

Then one JSON line of per-kernel numbers, and last
``{"ok": true, "device": {...}}``.  Any failed phase raises, so the run
exits non-zero without that last line.
"""
from __future__ import annotations

import dataclasses
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
# B1, B2 and B3's FMA kernels on float32 copies of the phase-3 stream
# against their plain versions: the same float32 arithmetic in another
# order (readings on an H100 at most 1.4e-6, PERF.md), so any dropped key
# shows
PAGED_F32_TOL = 1e-4
# the paper's peaks per experiment (src/repro/core/costmodel.py:32)
PAPER_PEAKS = 800_000
# B7 against its plain version, |kernel - plain| <= PV_TOL * (1 + |plain|):
# both run the same float32 arithmetic, summed in other orders and with
# fused multiply-adds in the kernel; on an H100 they differ by at most
# 1.5e-6 on the path's patches (PERF.md)
PV_TOL = 1e-5
# B6/B6f/B6b against their plain versions on the same inputs: every
# element within |kernel - plain| <= rtol * |plain| + atol, and each whole
# output within ||kernel - plain||_2 <= rel_l2 * ||plain||_2.  Two gates,
# each limit 3-5x its largest reading over both 8a shapes on an H100
# (PERF.md; the readings are printed as "atol needed" and "rel_l2"):
# - float32 inputs (the kernels take them too): the same arithmetic in
#   another summation order (readings: atol 2.8e-5, rel_l2 3.7e-6, both
#   dk at G 9), so a dropped key tile, q head or band segment shows at
#   any element, however small;
# - bfloat16 inputs, the main path's type.  rtol is one bfloat16 ulp
#   (2^-7 of the value), the most that two roundings to bfloat16 of nearly
#   equal float32 values can differ by.  The atol covers the float32
#   difference before that rounding.  In the backward that is summation
#   order and the tensor cores' accumulation (the kernels carry float32
#   sums tile by tile, and split p and ds into three bf16 terms; PERF.md
#   has the readings).  In the forward the kernel rounds the
#   softmax weights to bfloat16 before PV, as the TPU kernel does and the
#   plain version does not; that error scales with the row (a row
#   averaging n keys has values and errors ~1/sqrt(n) of |v|), so o's atol
#   is a share of its row's largest |plain|
FA_F32_RTOL = 1e-4
FA_F32_ATOL = 1e-4
FA_F32_REL_L2 = 2e-5
FA_BF16_RTOL = 2.0 ** -7
FA_BF16_O_ROW = 1e-2          # x the row's largest |plain|; reading 3.5e-3
FA_BF16_GRAD_ATOL = 2e-5      # reading 3.7e-6
FA_BF16_REL_L2 = {"o": 1e-2, "grad": 5e-4}   # readings 2.2e-3, 1.2e-4
FA_LSE_ATOL = 1e-5            # float32 logsumexp, either input type:
FA_LSE_REL_L2 = 2e-7          # readings 1.9e-6, 4.6e-8
# the kernel and plain training steps from the initial state (bfloat16
# compute; attention rounds and sums differently on the two paths) must
# agree to these relative tolerances in loss and gradient norm, about 10x
# the first card run's readings of 2.5e-6 and 1.1e-5 (PERF.md).  A later
# state is gated in float32 (TRAIN_F32_RTOL), where the two paths differ
# only by summation order: on a step-10 state the two bf16 gradient norms
# read 9 % apart, both ~50 % off the float32 one (an open question,
# ROADMAP C), which phase 8b prints
TRAIN_LOSS_RTOL = 3e-5
TRAIN_GRAD_NORM_RTOL = 1.5e-4
TRAIN_F32_RTOL = 1e-4
TRAIN_LAYERS = 4
TRAIN_STEPS = 10
TRAIN_LR = 3e-4               # the training launcher's default
TOP_KERNELS = 12              # device kernels listed from the profiled step
# B5 and B4 against their plain versions (phase 9a; the readings are
# printed).  float32 inputs run the FMA kernels, the same arithmetic in
# another order: every element within SCAN_F32_TOL * (1 + |plain|)
# (readings at the full-width shapes on an H100: 1.2e-7 B5, 7.3e-7 B4).
# In bf16 the plain versions round their intermediates (decay weights, W
# or the gated scores, the carried states) and their products' outputs to
# bf16; the tensor-core kernels round the intermediates where the plain
# versions do (B5: W, the decays, B o decay and S; B4: q / sqrt(hd), the
# gated scores and C) but keep their products in float32: the whole
# within SCAN_BF16_REL_L2 in the 2-norm and every element within
# SCAN_BF16_MAX x the largest |plain| (PERF.md has the readings)
SCAN_F32_TOL = 5e-6
SCAN_BF16_REL_L2 = 1e-2
SCAN_BF16_MAX = 2e-2
# the full-depth prefills (phase 9b, 9c), kernel against plain path, the
# last position's logits as a relative 2-norm.  float32 forwards differ by
# summation order (readings 4.6e-6 zamba2-2.7b, 3.5e-5 xlstm-1.3b).  The
# bf16 steps differ by the scans' roundings, compounded over the depth
# (readings 3.1e-2 zamba2-2.7b, 1.6e-1 xlstm-1.3b, whose 42 mLSTM layers
# each round C, the gated scores and q / sqrt(hd) to bf16 on the plain
# path only); each bf16 step's distance from the float32 kernel forward
# is printed beside them
RECURRENT_F32_REL_L2 = 2e-4
RECURRENT_BF16_REL_L2 = {"zamba2-2.7b": 8e-2, "xlstm-1.3b": 4e-1}
PREFILL_SEQ = 4096            # tokens a prefill (32 SSD / mLSTM chunks)
SERVE_SLOTS = 2
SERVE_REQUESTS = 3            # more requests than slots: a slot is reused
# kernel prefills timed after the first, whose median phase 17 reads (the
# sLSTM's prefill takes ≈ 10 s a run, so it gets fewer)
PREFILL_TIMED = {"zamba2-2.7b": 5, "xlstm-1.3b": 3}
SERVE_NEW = 8
SEED = 0
DEVICE = "cuda"
# phase 10: the MoE family, the VLM backbone and command-r-35b.
# deepseek-moe-16b's kernel-vs-plain steps: routing is discrete, so where
# the two paths' attention rounds differently a token whose k-th and
# (k+1)-th expert probabilities are that close takes another expert, and
# its logits, its lane's later tokens and its group's later capacity slots
# move by O(1) (on the card, left free, bf16 routes differed in 6-7 % of
# the first MoE layer's tokens and 70-82 % of the last's).  So the plain
# run takes the kernel run's routes (``_RoutePin``), and the share of
# (token, MoE layer) whose own top-k on the plain path differs from the
# kernel path's is gated (MOE_ROUTE_SHARE).  In float32, at MOE_F32_LAYERS
# (1 dense + 3 MoE layers; ~9 GB of weights), phase 5's logits gate (max
# err <= 0.05 x max |logit|, argmax agreement >= 0.9) holds on every row
# (readings: no route differed, max err < 1e-4).  In bf16 at full depth
# the logits are gated as the repo's other full-depth bf16 steps are, as
# a relative 2-norm (MOE_BF16_REL_L2), phase 5's numbers printed: these
# random logits are small and near-tied (max |logit| 4.6 against
# gemma-7b's 29), and with routes pinned the first card run read rel_l2
# 5.33e-2, max err 0.064 x max |logit| and argmax agreement 0.886.  The
# bf16 limits are about 3.5x those first readings (PERF.md)
MOE_F32_LAYERS = 4
MOE_ROUTE_SHARE = {"float32": 1e-2, "bfloat16": 6e-1}   # reading 0.187
MOE_BF16_REL_L2 = 2e-1
# tokens a request of the speculation drains after each phase-10 fleet
SPEC_NEW = 16
# llava-next-mistral-7b's image prefill: anyres patches + text = 4096
VLM_PATCHES, VLM_TEXT = 2880, 1216
# its kernel-vs-plain last-position logits, relative 2-norm
# (limits about 3.5-4x the first card readings, 4.28e-2 and 1.75e-5;
# both bf16 prefills read 3.8e-2 from the float32 kernel forward)
VLM_BF16_REL_L2 = 1.5e-1
VLM_F32_REL_L2 = 7e-5


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


def _per_token_bytes(s, segments) -> int:
    """The K/V bytes the per-token read (B2) must move on these segments:
    every token reads its lane's blocks up to its own position (from the
    window's first on), each once; plus q and out once."""
    q, k = s["q"], s["k"]
    Hkv, D = k.shape[2], k.shape[3]
    bs, window = s["bs"], s["window"]
    per_key = Hkv * (D * k.element_size() + (4 if s["scales"] else 0)) * 2
    blocks = rows = 0
    for start, n in segments:
        for p in range(start, start + n):
            first = max(0, p - window + 1) if window else 0
            blocks += p // bs - first // bs + 1
        rows += n
    return blocks * bs * per_key + 2 * rows * q.shape[-2] * D * \
        q.element_size()


def _tensor_core_check() -> None:
    """The split-sweep libraries of B1, B2 and B3 must hold tensor-core
    instructions (SASS HMMA, mma.sync); the FMA ones hold none."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import paged_attention as pa
    tc = (pa.TILED_TC, pa.RAGGED_TC, pa.ROWS_TC)
    counts = {src: _build.sass_count(src, "HMMA")
              for src in tc + (pa.TILED, pa.RAGGED, pa.ROWS)}
    print("paged libraries (cuobjdump -sass): " + ", ".join(
        f"{src} HMMA={n}" for src, n in counts.items()), flush=True)
    if not all(counts[src] for src in tc):
        raise AssertionError("a bf16 paged-attention library holds no HMMA")


def _fma_checks(s, r, tol) -> dict:
    """B1, B2, B3 chunk and B3 decode on float32 copies of the stream (the
    FMA kernels), against their plain versions, with their times."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa
    f = dict(s, q=s["q"].float(), k=s["k"].float(), v=s["v"].float())
    segs, T = s["segments"], s["T"]
    out = {}
    targs = (f["q"], f["k"], f["v"], s["tables"], s["meta"], s["row_tile"])
    tkw = dict(tile=s["tile"], window=s["window"])
    out[pa.TILED] = _check_kernel(
        f"{pa.TILED} float32 FMA",
        lambda: ops.paged_attention_ragged_tiled(*targs, use_kernel=True,
                                                 **tkw),
        lambda: ops.paged_attention_ragged_tiled(*targs, use_kernel=False,
                                                 **tkw),
        lambda o: o[:T], tol, _library_call(f, segs, f["q"][:T]),
        _bound(f, segs, s["tables_np"].nbytes + s["meta_np"].nbytes))
    pargs = (f["q"], f["k"], f["v"], s["token_tables"], s["token_pos"])
    kw = dict(window=s["window"])
    out[pa.RAGGED] = _check_kernel(
        f"{pa.RAGGED} float32 FMA",
        lambda: ops.paged_attention_ragged(*pargs, use_kernel=True, **kw),
        lambda: ops.paged_attention_ragged(*pargs, use_kernel=False, **kw),
        lambda o: o[:T], tol, _library_call(f, segs, f["q"][:T]),
        _bound(f, segs, s["token_tables_np"].nbytes
               + s["token_pos"].numel() * 4))
    rargs = (r["q"].float(), f["k"], f["v"], s["tables"], r["q_starts"],
             r["q_lens"])
    out[pa.ROWS] = _check_kernel(
        f"{pa.ROWS} chunk float32 FMA",
        lambda: ops.paged_attention_chunk(*rargs, use_kernel=True, **kw),
        lambda: ops.paged_attention_chunk(*rargs, use_kernel=False, **kw),
        lambda o: torch.cat([o[b, :n] for b, (_, n) in enumerate(segs)]),
        tol, _library_call(f, segs, f["q"][:T]),
        _bound(f, segs, s["tables_np"].nbytes + 2 * 4 * len(segs)))
    dargs = (r["q_dec"].float(), f["k"], f["v"], s["tables"], r["ctx_lens"])
    out[pa.ROWS + " decode"] = _check_kernel(
        f"{pa.ROWS} decode float32 FMA",
        lambda: ops.paged_attention(*dargs, use_kernel=True, **kw),
        lambda: ops.paged_attention(*dargs, use_kernel=False, **kw),
        lambda o: o, tol,
        _library_call(f, r["dec_segments"], r["q_dec"].float()),
        _bound(f, r["dec_segments"], s["tables_np"].nbytes + 4 * len(segs)))
    return out


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
    """B1, B2 and B3 against their plain versions at the main paths'
    configurations (on float32 copies too, once), after the tensor-core
    count of their bf16 libraries.  Returns {kernel:
    {config: numbers}}; raises if any disagrees."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref as kref
    configs = [
        # name, Hkv, G, D, pool dtype, window, tolerance on max |err|
        ("gemma-7b bf16", 16, 1, 256, torch.bfloat16, 0, 5e-2),
        ("gemma-7b int8", 16, 1, 256, torch.int8, 0, 5e-2),
        ("starcoder2-7b bf16 window", 4, 9, 128, torch.bfloat16, 256, 5e-2),
        # phase 10's paged reads
        ("deepseek-moe-16b bf16", 16, 1, 128, torch.bfloat16, 0, 5e-2),
        ("command-r-35b bf16", 8, 8, 128, torch.bfloat16, 0, 5e-2),
        ("llava-next-mistral-7b bf16 window", 8, 4, 128, torch.bfloat16,
         4096, 5e-2),
        # phase 14's shards of gemma-7b's pools (TP 2: 8 kv heads, in
        # bf16 and int8; TP 4: 4)
        ("gemma-7b TP 2 shard bf16", 8, 1, 256, torch.bfloat16, 0, 5e-2),
        ("gemma-7b TP 2 shard int8", 8, 1, 256, torch.int8, 0, 5e-2),
        ("gemma-7b TP 4 shard bf16", 4, 1, 256, torch.bfloat16, 0, 5e-2),
    ]
    _tensor_core_check()
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
        pt_bytes = _per_token_bytes(s, segs)
        pt_ms = pt_bytes / HBM_BYTES_PER_S * 1e3
        results[pa.RAGGED][name].update(per_token_bytes=pt_bytes,
                                        per_token_ms=pt_ms)
        print(f"kernel bytes [{pa.RAGGED} {name}]: per-token reads "
              f"{pt_bytes / 1e6:.1f} MB, {pt_ms:.4f} ms at the HBM rate "
              f"(bound {results[pa.RAGGED][name]['bound_ms']:.4f} ms: each "
              f"needed block once; kernel "
              f"{results[pa.RAGGED][name]['ms']:.4f} ms)", flush=True)

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
        if name == "gemma-7b bf16":
            for kernel, numbers in _fma_checks(s, r, PAGED_F32_TOL).items():
                results[kernel]["gemma-7b float32 FMA"] = numbers
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


def phase_main_path(api, params, label, engine_kw, kernel, *,
                    speculates: bool = True):
    """Serve the arch's shared-prefix fleet (``profile_serve.serve_fleet``)
    through the paged engine with ``engine_kw``; every step must launch
    ``kernel`` once per layer and no other paged read, and the prefix
    cache and copy-on-write must have run, and with ``speculates``
    speculation too (gemma-7b's random greedy tokens repeat, so the
    engine's n-gram proposer drafts on this fleet).  Returns that
    kernel's launches."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.profile_serve import serve_fleet
    cfg = api.cfg
    max_new = 32
    pa.reset_launch_counts()
    eng, finished, wall = serve_fleet(api, params, max_new=max_new,
                                      seed=SEED, device=DEVICE, **engine_kw)
    launches = dict(pa.launch_counts)
    s = eng.stats()
    print(f"main path [{label}]: {cfg.name} full width (d_model="
          f"{cfg.d_model}, {cfg.n_heads}x{cfg.resolved_head_dim} heads, "
          f"d_ff={cfg.d_ff}, vocab={cfg.vocab_size}, layers={cfg.n_layers}) "
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
            and (s["spec_verifications"] > 0 or not speculates)):
        raise AssertionError(f"[{label}] prefix cache, CoW or speculation "
                             "did not run")
    return launches[kernel]


# ---------------------------------------------------------------------------
# phase 5: full-width steps, kernel against plain path
# ---------------------------------------------------------------------------
def _step_runs(api, params, *, dtype=None, routes=None):
    """One mixed batch through ``ragged_step`` (segment-tiled, then
    per-token) and through ``paged_step`` (the same segments as a
    rectangle), each with the kernel and then on the plain path from the
    same pools (pools and compute in ``dtype``, default the parameters').
    Yields (label, T, out): ``out[use_kernel]`` holds the real rows'
    logits, and with ``routes`` (a ``_RoutePin``, started before each
    run) ``out[use_kernel, "routes"]`` that run's own top-k indices of
    each MoE layer, cut to its real rows."""
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
                                 dtype=dtype or torch.bfloat16,
                                 device=DEVICE)
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

    def real_rows(x, flat_stream):
        if flat_stream:                      # (T_pad, ...) or (1, T_pad, ...)
            return x[0, :T] if x.shape[0] == 1 and x.dim() > 2 else x[:T]
        return torch.cat([x[b, :n] for b, n in enumerate(lens)])

    for label, meta, step, toks, kw in (
            ("ragged_step tiled", tiled, api.ragged_step,
             t32(tokens + pad), {"tile": tile}),
            ("ragged_step per-token", per_token, api.ragged_step,
             t32(tokens + pad), {}),
            (f"paged_step rectangular C={C}", rect, api.paged_step,
             t32(rect_tokens), {})):
        flat_stream = label.startswith("ragged")
        out = {}
        for use_kernel in (True, False):
            for k, v in saved.items():
                cache["scan"][k].copy_(v)
            cache.update(meta)
            if routes is not None:
                routes.start(use_kernel)
            logits, _ = step(params, cache, toks, use_kernel=use_kernel,
                             **kw)
            out[use_kernel] = real_rows(logits, flat_stream)
            if routes is not None:
                out[use_kernel, "routes"] = [real_rows(t, flat_stream)
                                             for t in routes.own]
            for k in ("tile_meta", "row_tile", "token_lane", "token_pos",
                      "slot_mapping", "q_lens"):
                cache.pop(k, None)
        _sync()
        yield label, T, out
        del out
        torch.cuda.empty_cache()


def phase_step_vs_plain(api, params):
    """The mixed batch of ``_step_runs`` through each step with the kernel
    and on the plain path from the same pools; logits must agree."""
    import torch
    for label, T, out in _step_runs(api, params):
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
        del a, b


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
        if label.startswith(f"Np={PAPER_PEAKS}"):
            # the fit's share: the same call with no Gauss-Newton step
            # (marginals, starting moments and stores only)
            from repro_torch.kernels import pseudo_voigt as pv
            ms0 = _median_ms(lambda: pv.pseudo_voigt_fit(p, n_iter=0),
                             reps=20)
            print(f"kernel time [pseudo_voigt {label} n_iter=0]: "
                  f"ms={ms0:.4f}", flush=True)
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


# ---------------------------------------------------------------------------
# phase 8a: the flash-attention kernels against their plain versions
# ---------------------------------------------------------------------------
def _visible_pairs(S: int, window: int) -> int:
    """(query, key) pairs inside the causal band (and window) of S."""
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def _fa_bound(B, H, Hkv, S, D, window, *, flops_per_pair, head_tensors,
              kv_tensors, f32_rows) -> tuple:
    """Least time of one flash-attention kernel: ``flops_per_pair`` x D
    operations for every visible (query, key) pair of every query head at
    the bf16 peak, against ``head_tensors`` (B, H, S, D) and
    ``kv_tensors`` (B, Hkv, S, D) bf16 tensors and ``f32_rows`` (B, H, S)
    float32 rows read or written once, at the memory rate."""
    flops = flops_per_pair * D * _visible_pairs(S, window) * B * H
    nbytes = (2 * B * S * D * (head_tensors * H + kv_tensors * Hkv)
              + 4 * f32_rows * B * H * S)
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flop_ms = flops / BF16_FLOPS * 1e3
    return (byte_ms, "bytes") if byte_ms >= flop_ms else (flop_ms,
                                                          "operations")


def _fa_compare(label, outputs) -> float:
    """Hold each of ``outputs`` ((name, kernel's, plain's, rtol, atol,
    rel_l2, per_row) each) to its plain version: every element within
    rtol * |plain| + atol (atol times the row's largest |plain| where
    ``per_row``) and the whole within rel_l2 in the 2-norm.  Prints the
    readings the limits are set from: the largest and the median error,
    the atol each output needs at its rtol (max of |err| - rtol * |plain|,
    over the row's largest |plain| where ``per_row``) and the relative
    2-norm error.  Returns the largest error; raises if any output is over
    a limit or not finite."""
    import torch
    errs = []
    for name, a, b, rtol, atol, rel_l2, per_row in outputs:
        a, b = a.float(), b.float()
        diff = (a - b).abs()
        unit = (b.abs().amax(-1, keepdim=True).clamp_min(1e-30) if per_row
                else torch.ones((), device=b.device))
        excess = diff - rtol * b.abs()
        over = int((excess > atol * unit).sum())
        need = (excess / unit).max().item()
        rel = (diff.norm() / b.norm()).item()
        errs.append(diff.max().item())
        print(f"kernel check [{label}] {name}: max_abs_err={errs[-1]:.3e} "
              f"median_abs_err={diff.median().item():.3e} "
              f"max_abs={b.abs().max().item():.3e} "
              f"median_abs={b.abs().median().item():.3e} "
              f"atol needed at rtol {rtol:.3g}="
              f"{need:.3e}{' x row max |plain|' if per_row else ''} "
              f"(atol {atol:g}, {over} over) rel_l2={rel:.3e} "
              f"(limit {rel_l2:g})", flush=True)
        if over or not rel <= rel_l2 or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{label} {name} disagrees with its plain "
                                 f"version: {over} over tolerance, rel_l2 "
                                 f"{rel}")
        del diff, excess
    return max(errs)


def _fa_check_all(label, q, k, v, do, kw, f32: bool):
    """B6f, B6, dq and dk/dv on (q, k, v, do) against their plain versions
    with the limits of the inputs' type.  Returns (o, lse) of B6f and the
    largest error of B6f, B6 and the backward."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref as kref
    if f32:
        lim_o = lim_g = (FA_F32_RTOL, FA_F32_ATOL, FA_F32_REL_L2, False)
    else:
        lim_o = (FA_BF16_RTOL, FA_BF16_O_ROW, FA_BF16_REL_L2["o"], True)
        lim_g = (FA_BF16_RTOL, FA_BF16_GRAD_ATOL, FA_BF16_REL_L2["grad"],
                 False)
    lim_lse = (0.0, FA_LSE_ATOL, FA_LSE_REL_L2, False)
    tag = f"{label} {'float32' if f32 else 'bf16'}"
    # the plain float32 versions first: their scores take ~10 GB
    want_o, want_lse = kref.attention_lse_reference(q, k, v, **kw)
    o, lse = fa.flash_attention_lse(q, k, v, **kw)
    want_b = kref.attention_bwd_reference(q, k, v, o, lse, do, **kw)
    got_b = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    err_f = _fa_compare(f"{fa.B6F} {tag}", [
        ("o", o, want_o, *lim_o), ("lse", lse, want_lse, *lim_lse)])
    err_o = _fa_compare(f"{fa.B6} {tag}", [
        ("o", fa.flash_attention(q, k, v, **kw), want_o, *lim_o)])
    err_b = _fa_compare(f"{fa.B6_DQ}/{fa.B6_DKV} {tag}", [
        (n, a, b, *lim_g)
        for n, a, b in zip(("dq", "dk", "dv"), got_b, want_b)])
    del want_o, want_lse, want_b, got_b
    torch.cuda.empty_cache()
    return o, lse, err_f, err_o, err_b


def _fa_flops(B, H, S, D, window, flops_per_pair) -> float:
    """The operations of one flash-attention kernel on its inputs (the
    function's, as ``_fa_bound`` counts them)."""
    return flops_per_pair * D * _visible_pairs(S, window) * B * H


def _fa_rate(name, label, ms, flops, bound_ms) -> None:
    print(f"kernel rate [{name} {label}]: {flops / ms / 1e9:.1f} TFLOP/s "
          f"({flops / 1e9:.1f} GFLOP in {ms:.4f} ms), "
          f"{bound_ms / ms:.3f} of its bound", flush=True)


def _fa_tensor_core_check() -> None:
    """The bf16 flash-attention libraries must hold wgmma (SASS HGMMA)
    and TMA loads (UTMALDG); the float32 ones are FMA code."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    counts = {src: (_build.sass_count(src, "HGMMA"),
                    _build.sass_count(src, "UTMALDG"))
              for src in (fa.FWD_TC, fa.BWD_TC, fa.FWD, fa.BWD)}
    print("flash libraries (cuobjdump -sass): " + ", ".join(
        f"{src} HGMMA={h} UTMALDG={t}" for src, (h, t) in counts.items()),
        flush=True)
    if not all(h and t for h, t in (counts[fa.FWD_TC], counts[fa.BWD_TC])):
        raise AssertionError("a bf16 flash-attention library holds no "
                             "HGMMA or no TMA load")


# phase 8a's cells: (label, B, H, Hkv, S, D, window); the first is the
# main path's (phase 8b's) shape
FA_CASES = [("gemma-7b S=4096", 1, 16, 16, 4096, 256, 0),
            ("starcoder2-7b S=8192 window=4096", 1, 36, 4, 8192, 128, 4096),
            # phase 13's training shapes: whisper-base's decoder and
            # zamba2-2.7b's shared attention block
            ("whisper-base S=448", 8, 8, 8, 448, 64, 0),
            ("zamba2-2.7b S=2048", 1, 32, 32, 2048, 80, 0),
            # phase 15's TP 2 shards: half the heads on a position
            ("gemma-7b TP 2 shard S=4096", 1, 8, 8, 4096, 256, 0),
            ("deepseek-moe-16b TP 2 shard S=2048", 1, 8, 8, 2048, 128, 0),
            # phase 16a's TP 2 shard of llava's backbone: 16 q and 4 kv
            # heads, its 4096-token window over 2880 patches + 1216 tokens
            ("llava-next-mistral-7b TP 2 shard S=4096 window=4096", 1, 16, 4,
             4096, 128, 4096)]


def phase_flash_kernels():
    """B6, B6f, dq and dk/dv against their plain versions at gemma-7b's
    training shape and at starcoder2-7b's heads and window; the bf16
    kernels' SASS must hold HGMMA.  Returns {kernel: numbers} at gemma-7b's
    shape; raises on any disagreement."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref as kref
    _fa_tensor_core_check()
    cases = FA_CASES
    results = {}
    for label, B, H, Hkv, S, D, window in cases:
        g = torch.Generator(device=DEVICE)
        g.manual_seed(SEED)
        # the model's (B, S, heads, D) layout, read through transposed
        # views as the training path reads it
        mk = lambda h: torch.randn((B, S, h, D), generator=g,
                                   device=DEVICE).to(torch.bfloat16
                                                     ).transpose(1, 2)
        q, k, v, do = mk(H), mk(Hkv), mk(Hkv), mk(H)
        kw = dict(causal=True, window=window)
        print(f"flash inputs [{label}]: B={B} H={H} Hkv={Hkv} S={S} D={D} "
              f"window={window} bf16, visible pairs per head="
              f"{_visible_pairs(S, window)}", flush=True)
        # float32 copies of the same values first (checked, then the FMA
        # kernels timed), then the path's bf16
        f32 = [t.float() for t in (q, k, v, do)]
        o32, lse32 = _fa_check_all(label, *f32, kw, f32=True)[:2]
        t32 = {fa.B6: _median_ms(lambda: fa.flash_attention(*f32[:3], **kw),
                                 reps=3, inner=1, warmup=1)}
        for name in (fa.B6_DQ, fa.B6_DKV):
            t32[name] = _median_ms(_bwd_kernel_call(
                name, *f32[:3], o32, lse32, f32[3], kw), reps=3, inner=1,
                warmup=1)
        for name, per_pair in ((fa.B6, 4), (fa.B6_DQ, 6), (fa.B6_DKV, 8)):
            rate = _fa_flops(B, H, S, D, window, per_pair) / t32[name] * 1e3
            print(f"kernel check [{name} {label} float32 FMA]: "
                  f"ms={t32[name]:.4f} {rate / 1e12:.1f} TFLOP/s "
                  f"({rate / F32_FLOPS:.3f} of the float32 peak)", flush=True)
        del f32, o32, lse32
        torch.cuda.empty_cache()
        o, lse, err_f, err_o, err_b = _fa_check_all(label, q, k, v, do, kw,
                                                    f32=False)

        # the library yardstick: SDPA on kv expanded to H heads (built
        # here, outside the timed call), causal, the window as a mask
        G = H // Hkv
        kx = k.repeat_interleave(G, dim=1).detach().requires_grad_(True)
        vx = v.repeat_interleave(G, dim=1).detach().requires_grad_(True)
        qx = q.detach().requires_grad_(True)
        if window:
            pos = torch.arange(S, device=DEVICE)
            mask = ((pos[None, :] <= pos[:, None])
                    & (pos[:, None] - pos[None, :] < window))
            sdpa = lambda: F.scaled_dot_product_attention(qx, kx, vx,
                                                          attn_mask=mask)
        else:
            sdpa = lambda: F.scaled_dot_product_attention(qx, kx, vx,
                                                          is_causal=True)

        def sdpa_fwd():
            with torch.no_grad():
                return sdpa()

        def sdpa_fwd_bwd():
            return torch.autograd.grad(sdpa(), (qx, kx, vx), do)

        lib_f = _median_ms(sdpa_fwd, reps=5, inner=3, warmup=1)
        lib_b = _median_ms(sdpa_fwd_bwd, reps=5, inner=3, warmup=1)
        del kx, vx, qx
        args = (B, H, Hkv, S, D, window)
        rows = {
            fa.B6: (err_o, lambda: fa.flash_attention(q, k, v, **kw),
                    lambda: kref.attention_reference(q, k, v, **kw), lib_f,
                    _fa_bound(*args, flops_per_pair=4, head_tensors=2,
                              kv_tensors=2, f32_rows=0)),
            fa.B6F: (err_f, lambda: fa.flash_attention_lse(q, k, v, **kw),
                     lambda: kref.attention_lse_reference(q, k, v, **kw),
                     lib_f, _fa_bound(*args, flops_per_pair=4,
                                      head_tensors=2, kv_tensors=2,
                                      f32_rows=1)),
        }
        for name, (err, kern, plain, lib, (bound_ms, bound_by)) in \
                rows.items():
            ms = _median_ms(kern, reps=5, inner=3, warmup=1)
            plain_ms = _median_ms(plain, reps=3, inner=1, warmup=1)
            results.setdefault(name, {})[label] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib,
                bound_ms=bound_ms, bound_by=bound_by)
            torch.cuda.empty_cache()
        # B6b: the two kernels are timed apart through their C entry
        # points; their plain version is one function, timed once
        plain_b = _median_ms(lambda: kref.attention_bwd_reference(
            q, k, v, o, lse, do, **kw), reps=3, inner=1, warmup=1)
        for name, n_pairs, heads, kvs in ((fa.B6_DQ, 6, 3, 2),
                                          (fa.B6_DKV, 8, 2, 4)):
            bound_ms, bound_by = _fa_bound(*args, flops_per_pair=n_pairs,
                                           head_tensors=heads,
                                           kv_tensors=kvs, f32_rows=2)
            ms = _median_ms(_bwd_kernel_call(name, q, k, v, o, lse, do, kw),
                            reps=5, inner=3, warmup=1)
            results.setdefault(name, {})[label] = dict(
                max_abs_err=err_b, ms=ms, plain_ms=plain_b,
                library_ms=lib_b, bound_ms=bound_ms, bound_by=bound_by)
        for name, per_pair in ((fa.B6, 4), (fa.B6F, 4), (fa.B6_DQ, 6),
                               (fa.B6_DKV, 8)):
            r = results[name][label]
            print(f"kernel check [{name} {label}]: ms={r['ms']:.4f} "
                  f"plain_ms={r['plain_ms']:.4f} "
                  f"library_ms={r['library_ms']:.4f} "
                  f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']})"
                  + (" (plain and library: the whole backward)"
                     if name in (fa.B6_DQ, fa.B6_DKV) else ""), flush=True)
            _fa_rate(name, label, r["ms"],
                     _fa_flops(B, H, S, D, window, per_pair), r["bound_ms"])
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    return {name: c[cases[0][0]] for name, c in results.items()}


def _bwd_kernel_call(name, q, k, v, o, lse, do, kw):
    """A call of one backward kernel alone (dq or dk/dv) on the inputs
    ``flash_attention_bwd`` gives it."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    delta = (do.float() * o.float()).sum(dim=-1).contiguous()
    grads = tuple(torch.empty_like(t) for t in (q, k, v))
    which = "dq" if name == fa.B6_DQ else "dkv"
    return lambda: fa.launch_bwd_kernel(which, q, k, v, do, lse, delta,
                                        *grads, **kw)


# ---------------------------------------------------------------------------
# phase 8b: LM training at full width through the kernels
# ---------------------------------------------------------------------------
def _group_train(name: str) -> str:
    """Kernel family of a device kernel name in a training step."""
    if "flash_attention::" in name or "flash_wgmma" in name:
        return "flash attention"
    if any(k in name for k in ("nvjet", "gemm", "splitKreduce", "cutlass")):
        return "gemm"
    return "other"


def _loss_and_grad_norm(loss_fn, params, batch) -> tuple:
    """The loss of ``params`` on ``batch`` and the global norm of its
    gradient, as a train step reports them, without the update."""
    import torch
    from repro_torch.optim.optimizers import tree_leaves, tree_map
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    loss, _ = loss_fn(tree_map(lambda _: next(it), params), batch)
    grads = torch.autograd.grad(loss, leaves)
    norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
    return float(loss.detach()), float(norm)


def phase_training():
    """gemma-7b at full width (4 layers) trained 10 steps through the
    kernels, with the plain path's step on the same state and batch as the
    first, a float32 kernel-against-plain check on the last state, and one
    no-grad eval forward; the counts of every kernel are zeroed just
    before each run and read just after.  Returns the launches of the 10
    kernel steps together and of the eval forward, and the measured step
    for phase 17 (:func:`_measured`); raises if a check fails."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import TRAIN_4K
    from repro_torch.data.synthetic import lm_token_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import pseudo_voigt as pv
    from repro_torch.launch.profile_serve import _busy_us
    from repro_torch.launch.specs import (make_loss_for_shape,
                                          make_train_step_fn)
    from repro_torch.models.api import build_model
    cfg = dataclasses.replace(get_config("gemma-7b"), n_layers=TRAIN_LAYERS)
    api = build_model(cfg)
    L = cfg.n_layers
    shape = dataclasses.replace(TRAIN_4K, global_batch=1)
    S = shape.seq_len
    t0 = time.perf_counter()
    params = api.init(seed=SEED, device=DEVICE, dtype=torch.float32)
    step_fn, opt = make_train_step_fn(api, shape, lr=TRAIN_LR)
    plain_step, _ = make_train_step_fn(api, shape, lr=TRAIN_LR,
                                       use_kernel=False)
    opt_state = opt.init(params)
    gen = torch.Generator()
    batches = []
    for step in range(1, TRAIN_STEPS + 1):
        gen.manual_seed(SEED + step)
        batches.append(lm_token_batch(gen, shape.global_batch, S,
                                      cfg.vocab_size, device=DEVICE))
    _sync()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"training: gemma-7b (d_model={cfg.d_model}, {cfg.n_heads}x"
          f"{cfg.resolved_head_dim} heads, d_ff={cfg.d_ff}, "
          f"vocab={cfg.vocab_size}) layers={L} of 28, {n_params / 1e9:.3f} B "
          f"params float32 masters, bf16 compute, adamw(lr={TRAIN_LR}, "
          f"grad_clip_norm=1.0), batch {shape.global_batch} x seq {S}, "
          f"remat per block; set-up {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card; "
          f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32}", flush=True)

    def zero_counts():
        fa.reset_launch_counts()
        pa.reset_launch_counts()
        pv.reset_launch_counts()

    def read_counts():
        out = dict(fa.launch_counts)
        out.update({k: v for k, v in pa.launch_counts.items() if v})
        out.update({k: v for k, v in pv.launch_counts.items() if v})
        return out

    torch.cuda.reset_peak_memory_stats()
    # the plain path's step (use_kernel=False: the reference's chunked
    # attention at S 4096) from the state and batch of the first kernel
    # step, run first so that only one new state is ever held
    zero_counts()
    t0 = time.perf_counter()
    new_p, new_s, m = plain_step(params, opt_state, batches[0])
    _sync()
    plain_ms = (time.perf_counter() - t0) * 1e3
    plain_counts = read_counts()
    loss_p, norm_p = float(m["loss"]), float(m["grad_norm"])
    del new_p, new_s, m
    torch.cuda.empty_cache()
    if any(plain_counts.values()):
        raise AssertionError(f"the plain step launched kernels: "
                             f"{plain_counts}")
    # the same state and batch in float32 (printed, not gated): how far
    # the bf16 gradient norm is from the float32 one before any training
    init_f32 = _loss_and_grad_norm(make_loss_for_shape(
        api, shape, compute_dtype=torch.float32), params, batches[0])
    torch.cuda.empty_cache()

    want_step = {fa.B6: 0, fa.B6F: 2 * L, fa.B6_DQ: L, fa.B6_DKV: L}
    losses, norms, times = [], [], []
    totals = dict.fromkeys(want_step, 0)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for i, batch in enumerate(batches):
        last = i == len(batches) - 1
        if last:
            prev = (params, opt_state)     # for the float32 check
        zero_counts()
        t0 = time.perf_counter()
        if last:
            with torch.profiler.profile(activities=acts) as prof:
                params, opt_state, m = step_fn(params, opt_state, batch)
                _sync()
        else:
            params, opt_state, m = step_fn(params, opt_state, batch)
            _sync()
        times.append(time.perf_counter() - t0)
        counts = read_counts()
        for k in totals:
            totals[k] += counts.get(k, 0)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        print(f"training step {i + 1}: loss={losses[-1]:.6f} "
              f"grad_norm={norms[-1]:.6f} wall_ms={times[-1] * 1e3:.2f}"
              f"{' (profiled)' if last else ''} "
              f"kernel_launches={json.dumps(counts)}", flush=True)
        if counts != want_step:
            raise AssertionError(f"step {i + 1} launches {counts} != "
                                 f"{want_step} (2L B6f, L dq, L dk/dv)")
        if not np.isfinite(losses[-1]):
            raise AssertionError(f"loss not finite at step {i + 1}")
    peak = torch.cuda.max_memory_allocated()
    ms = statistics.median(times[1:-1]) * 1e3   # not the first, profiled
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _busy_us(kernels) / 1e6
    groups = {"flash attention": 0.0, "gemm": 0.0, "other": 0.0}
    by_name = {}
    for e in kernels:
        ms_e = (e.time_range.end - e.time_range.start) / 1e3
        groups[_group_train(e.name)] += ms_e
        t = by_name.setdefault(e.name, [0.0, 0])
        t[0] += ms_e
        t[1] += 1
    print(f"training: {TRAIN_STEPS} steps, median ms/step over steps "
          f"2-{TRAIN_STEPS - 1}={ms:.2f} (steps: "
          f"{', '.join(f'{t * 1e3:.1f}' for t in times)}), tokens/s="
          f"{shape.global_batch * S / (ms / 1e3):.1f}, peak memory "
          f"{peak / 2**30:.2f} GiB (max_memory_allocated); loss "
          f"{losses[0]:.6f} -> {losses[-1]:.6f}", flush=True)
    print(f"training profile (step {TRAIN_STEPS}): wall_ms="
          f"{times[-1] * 1e3:.2f} device_busy_ms={busy * 1e3:.2f} "
          f"idle_share={1 - busy / times[-1]:.4f} (of the profiled step; "
          f"estimate for the unprofiled steps, this step's busy time over "
          f"their median wall: {1 - busy * 1e3 / ms:.4f}) "
          f"kernels={len(kernels)} "
          + " ".join(f"{g.replace(' ', '_')}_ms={v:.2f}"
                     for g, v in groups.items()), flush=True)
    for name, (t_ms, n) in sorted(by_name.items(),
                                  key=lambda kv: -kv[1][0])[:TOP_KERNELS]:
        print(f"  {t_ms:9.3f} ms {n:5d} calls  {name[:100]}", flush=True)
    print(f"training step 1 on the plain path (use_kernel=False): "
          f"loss={loss_p:.6f} grad_norm={norm_p:.6f} wall_ms={plain_ms:.2f} "
          f"kernel_launches={json.dumps(plain_counts)}; kernel path "
          f"loss={losses[0]:.6f} grad_norm={norms[0]:.6f}; relative "
          f"differences {abs(losses[0] - loss_p) / abs(loss_p):.3e}, "
          f"{abs(norms[0] - norm_p) / norm_p:.3e} (rtol "
          f"{TRAIN_LOSS_RTOL:g}, {TRAIN_GRAD_NORM_RTOL:g}); the kernel path "
          f"in float32 from the same state: loss={init_f32[0]:.6f} "
          f"grad_norm={init_f32[1]:.6f} (not gated)", flush=True)
    if not (abs(losses[0] - loss_p) <= TRAIN_LOSS_RTOL * abs(loss_p)
            and abs(norms[0] - norm_p) <= TRAIN_GRAD_NORM_RTOL * norm_p):
        raise AssertionError("the kernel step disagrees with the plain one")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")

    # the state and batch of the last step again: the kernel path against
    # the plain path in float32, and the plain path in bf16 beside the
    # kernel step's own bf16 numbers (printed, not gated: see
    # TRAIN_F32_RTOL)
    del params, opt_state, m
    params, _ = prev
    del prev
    torch.cuda.empty_cache()
    redo = {}
    for label, kw in (("kernel f32", {"compute_dtype": torch.float32}),
                      ("plain f32", {"compute_dtype": torch.float32,
                                     "use_kernel": False}),
                      ("plain bf16", {"use_kernel": False})):
        loss_fn = make_loss_for_shape(api, shape, **kw)
        redo[label] = _loss_and_grad_norm(loss_fn, params, batches[-1])
        torch.cuda.empty_cache()
    print(f"training step {TRAIN_STEPS}'s state again: kernel bf16 (the "
          f"step) loss={losses[-1]:.6f} grad_norm={norms[-1]:.6f}; "
          + "; ".join(f"{k} loss={lv:.6f} grad_norm={nv:.6f}"
                      for k, (lv, nv) in redo.items())
          + f" (float32 paths to rtol {TRAIN_F32_RTOL:g})", flush=True)
    (lk, nk), (lp, np_) = redo["kernel f32"], redo["plain f32"]
    if not (abs(lk - lp) <= TRAIN_F32_RTOL * abs(lp)
            and abs(nk - np_) <= TRAIN_F32_RTOL * np_):
        raise AssertionError("in float32 the kernel path disagrees with "
                             "the plain one")

    # one no-grad eval forward: B6 once a layer
    zero_counts()
    with torch.no_grad():
        logits, _ = api.forward(params, batches[-1]["tokens"],
                                window=api.effective_window(S))
        _sync()
    counts = read_counts()
    ok = (tuple(logits.shape) == (shape.global_batch, S, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()))
    print(f"eval forward (no grad): logits {tuple(logits.shape)} finite={ok} "
          f"kernel_launches={json.dumps(counts)}", flush=True)
    want_eval = {fa.B6: L, fa.B6F: 0, fa.B6_DQ: 0, fa.B6_DKV: 0}
    if counts != want_eval or not ok:
        raise AssertionError(f"eval forward: launches {counts} != "
                             f"{want_eval} or logits not finite")
    return totals, counts, _measured(
        "8b gemma-7b train (median of steps 2-9)", cfg, shape, ms)


# ---------------------------------------------------------------------------
# phase 9a: the scan kernels against their plain versions
# ---------------------------------------------------------------------------
def _scan_bound(nbytes: float, flops: float) -> tuple:
    """Least time of a call that must move ``nbytes`` and do ``flops``:
    the larger of the byte time at the memory rate and the operation time
    at the bf16 peak (the path's type)."""
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flop_ms = flops / BF16_FLOPS * 1e3
    return (byte_ms, "bytes") if byte_ms >= flop_ms else (flop_ms,
                                                          "operations")


def _ssd_bound(B, L, H, P, G, N, Q, esize) -> tuple:
    """B5: xdt read and y written in the input type, B and C read, dA in
    float32; per chunk and head the lower triangle of C B^T and of W xdt
    (Q (Q + 1) / 2 x (N + P) multiply-adds), C S^T and the state update
    (2 Q N P)."""
    nbytes = 2 * B * L * H * P * esize + 2 * B * L * G * N * esize \
        + 4 * B * L * H
    macs = (Q * (Q + 1) // 2 * (N + P) + 2 * Q * N * P) * (L // Q) * B * H
    return _scan_bound(nbytes, 2 * macs)


def _mlstm_bound(B, L, H, hd, Q, esize) -> tuple:
    """B4: q, k, v read and h written in the input type, the two gates in
    float32; per chunk and head the lower triangle of q k^T and of S v
    (Q (Q + 1) / 2 x 2 hd multiply-adds), q C and the C update
    (2 Q hd^2), q n and the n update (2 Q hd)."""
    nbytes = 4 * B * L * H * hd * esize + 2 * 4 * B * L * H
    macs = (Q * (Q + 1) // 2 * 2 * hd + 2 * Q * hd * hd + 2 * Q * hd) \
        * (L // Q) * B * H
    return _scan_bound(nbytes, 2 * macs)


def _scan_compare(label, got, want, f32: bool) -> float:
    """Hold a scan kernel's output to its plain version's: in float32
    every element within SCAN_F32_TOL * (1 + |plain|); in bf16 the whole
    within SCAN_BF16_REL_L2 in the 2-norm and every element within
    SCAN_BF16_MAX x the largest |plain|.  Prints the readings the limits
    are set from; returns the largest error; raises past a limit."""
    import torch
    a, b = got.float(), want.float()
    err = (a - b).abs()
    rel = (err.norm() / b.norm()).item()
    peak = b.abs().max().item()
    need = (err / (1 + b.abs())).max().item()
    finite = bool(torch.isfinite(a).all())
    print(f"kernel check [{label}]: max_abs_err={err.max().item():.3e} "
          f"max_abs={peak:.3e} err/(1+|plain|)={need:.3e} "
          f"max_err/max|plain|={err.max().item() / peak:.3e} "
          f"rel_l2={rel:.3e} finite={finite}", flush=True)
    if f32:
        ok = need <= SCAN_F32_TOL
    else:
        ok = rel <= SCAN_BF16_REL_L2 and err.max().item() <= \
            SCAN_BF16_MAX * peak
    if not (ok and finite):
        raise AssertionError(f"{label} disagrees with its plain version")
    return err.max().item()


def phase_scan_kernels():
    """B5 at zamba2-2.7b's shapes and B4 at xlstm-1.3b's, full width at
    PREFILL_SEQ tokens and at one sequence shorter than a chunk, from
    float32 inputs and their bf16 copies, against the plain versions on
    the card; then B6 at zamba2-2.7b's shared attention (32 x 80 heads).
    Returns {kernel: numbers} at the full-width bf16 shape; raises on any
    disagreement."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mlstm_scan as ml
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import ssm_scan as ssd
    g = torch.Generator(device=DEVICE)
    g.manual_seed(SEED)
    rn = lambda *s: torch.randn(s, generator=g, device=DEVICE)
    results = {}
    # B5: B, L, H, P, G, N, chunk
    for L in (PREFILL_SEQ, 96):
        B, H, P, G, N, Q = 1, 80, 64, 1, 64, 128
        label = f"{ssd.SSD} zamba2-2.7b L={L}"
        x, dt = rn(B, L, H, P) * 0.5, F.softplus(rn(B, L, H))
        A, Bm, Cm = -torch.exp(rn(H) * 0.3), rn(B, L, G, N) * 0.3, \
            rn(B, L, G, N) * 0.3
        for dtype in (torch.float32, torch.bfloat16):
            xs, Bs, Cs = (t.to(dtype) for t in (x, Bm, Cm))
            kern = lambda: ops.ssd_scan_heads(xs, dt, A, Bs, Cs, chunk=Q,
                                              use_kernel=True)
            plain = lambda: ops.ssd_scan_heads(xs, dt, A, Bs, Cs, chunk=Q,
                                               use_kernel=False)
            err = _scan_compare(f"{label} {str(dtype)[6:]}", kern(),
                                plain(), dtype == torch.float32)
            if L == PREFILL_SEQ and dtype == torch.float32:
                f32_ms = _median_ms(kern, reps=3, inner=2, warmup=1)
                print(f"kernel time [{label} float32 FMA]: ms={f32_ms:.4f} "
                      f"bound_ms={_ssd_bound(B, L, H, P, G, N, Q, 4)[0]:.4f}",
                      flush=True)
        if L != PREFILL_SEQ:
            continue
        # the kernel alone on the inputs the path hands it, bf16
        xdt = xs * dt[..., None].to(xs.dtype)
        dA = dt * A
        y = torch.empty_like(xdt)
        call = lambda: ssd.ssd_scan(xdt.transpose(1, 2), dA.transpose(1, 2),
                                    Bs.transpose(1, 2), Cs.transpose(1, 2),
                                    chunk=Q, out=y.transpose(1, 2))
        bound_ms, bound_by = _ssd_bound(B, L, H, P, G, N, Q, 2)
        results[ssd.SSD] = dict(
            max_abs_err=err, ms=_median_ms(call, reps=10, inner=5),
            plain_ms=_median_ms(plain, reps=3, inner=1, warmup=1),
            library_ms=None, bound_ms=bound_ms, bound_by=bound_by)
        # the same heads cut to one CTA a SM (a CTA takes 32 columns of P
        # of one head): how much the SMs that hold two CTAs cost
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        hs = sms // -(-P // 32)
        few = lambda: ssd.ssd_scan(
            xdt[:, :, :hs].transpose(1, 2), dA[:, :, :hs].transpose(1, 2),
            Bs.transpose(1, 2), Cs.transpose(1, 2), chunk=Q,
            out=y[:, :, :hs].transpose(1, 2))
        print(f"kernel time [{label} bfloat16, {hs} of {H} heads: "
              f"{hs * -(-P // 32)} CTAs on {sms} SMs]: ms="
              f"{_median_ms(few, reps=10, inner=5):.4f} (all {H} heads, "
              f"{H * -(-P // 32)} CTAs: {results[ssd.SSD]['ms']:.4f})",
              flush=True)
        del x, xs, xdt, y, Bm, Cm, Bs, Cs
    # B5: its bf16 library on the tensor cores (SASS HMMA, mma.sync)
    from repro_torch.kernels import _build
    hmma = _build.sass_count(ssd.SRC_TC, "HMMA")
    print(f"ssd libraries (cuobjdump -sass): {ssd.SRC_TC} HMMA={hmma}, "
          f"{ssd.SRC} HMMA={_build.sass_count(ssd.SRC, 'HMMA')}", flush=True)
    if not hmma:
        raise AssertionError("the bf16 SSD library holds no HMMA")
    # B4: its bf16 library on the tensor cores (SASS HMMA, mma.sync, in the
    # scores kernel; HGMMA, wgmma, and UTMALDG, TMA loads, in the scan)
    counts = {op: _build.sass_count(ml.MLSTM_TC, op)
              for op in ("HMMA", "HGMMA", "UTMALDG")}
    print(f"mlstm libraries (cuobjdump -sass): {ml.MLSTM_TC} " + " ".join(
        f"{op}={n}" for op, n in counts.items()) + f", {ml.MLSTM} "
          f"HMMA={_build.sass_count(ml.MLSTM, 'HMMA')}", flush=True)
    if not (counts["HMMA"] and counts["HGMMA"]):
        raise AssertionError("the bf16 mLSTM library holds no HMMA or HGMMA")
    # B4: B, L, H, hd, chunk
    for L in (PREFILL_SEQ, 64):
        B, H, hd, Q = 1, 4, 1024, 128
        label = f"{ml.MLSTM} xlstm-1.3b L={L}"
        q, k, v = rn(B, L, H, hd) * 0.5, rn(B, L, H, hd) * 0.5, \
            rn(B, L, H, hd) * 0.5
        li, lf = rn(B, L, H) * 0.5, F.logsigmoid(rn(B, L, H) + 2.0)
        for dtype in (torch.float32, torch.bfloat16):
            qs, ks, vs = (t.to(dtype) for t in (q, k, v))
            kern = lambda: ops.mlstm_scan_heads(qs, ks, vs, li, lf, chunk=Q,
                                                use_kernel=True)
            plain = lambda: ops.mlstm_scan_heads(qs, ks, vs, li, lf,
                                                 chunk=Q, use_kernel=False)
            err = _scan_compare(f"{label} {str(dtype)[6:]}", kern(),
                                plain(), dtype == torch.float32)
            if L == PREFILL_SEQ and dtype == torch.float32:
                f32_ms = _median_ms(kern, reps=3, inner=2, warmup=1)
                print(f"kernel time [{label} float32 FMA]: ms={f32_ms:.4f} "
                      f"bound_ms={_mlstm_bound(B, L, H, hd, Q, 4)[0]:.4f}",
                      flush=True)
        if L != PREFILL_SEQ:
            continue
        h = torch.empty_like(qs)
        tr = lambda t: t.transpose(1, 2)
        call = lambda: ml.mlstm_scan(tr(qs), tr(ks), tr(vs), tr(li), tr(lf),
                                     chunk=Q, out=tr(h))
        bound_ms, bound_by = _mlstm_bound(B, L, H, hd, Q, 2)
        results[ml.MLSTM] = dict(
            max_abs_err=err, ms=_median_ms(call, reps=5, inner=3),
            plain_ms=_median_ms(plain, reps=3, inner=1, warmup=1),
            library_ms=None, bound_ms=bound_ms, bound_by=bound_by)
        del q, k, v, qs, ks, vs, h
    for name, r in results.items():
        print(f"kernel check [{name} full width bf16]: ms={r['ms']:.4f} "
              f"plain_ms={r['plain_ms']:.4f} library_ms=null (no PyTorch "
              f"call computes the scan) bound_ms={r['bound_ms']:.4f} "
              f"({r['bound_by']})", flush=True)

    # B6 at head dim 80: zamba2-2.7b's shared attention, bf16, in the
    # model's (B, S, H, D) layout read through transposed views
    S, H, D = PREFILL_SEQ, 32, 80
    q, k, v = (rn(1, S, H, D).to(torch.bfloat16).transpose(1, 2)
               for _ in range(3))
    kw = dict(causal=True, window=0)
    err = _fa_compare(f"{fa.B6} zamba2-2.7b D={D} bf16", [
        ("o", fa.flash_attention(q, k, v, **kw),
         kref.attention_reference(q, k, v, **kw), FA_BF16_RTOL,
         FA_BF16_O_ROW, FA_BF16_REL_L2["o"], True)])
    with torch.no_grad():
        lib = _median_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), reps=5, inner=3, warmup=1)
    bound_ms, bound_by = _fa_bound(1, H, H, S, D, 0, flops_per_pair=4,
                                   head_tensors=2, kv_tensors=2, f32_rows=0)
    ms = _median_ms(lambda: fa.flash_attention(q, k, v, **kw), reps=5,
                    inner=3)
    plain_ms = _median_ms(lambda: kref.attention_reference(q, k, v, **kw),
                          reps=3, inner=1, warmup=1)
    print(f"kernel check [{fa.B6} zamba2-2.7b D={D} S={S} bf16]: "
          f"max_abs_err={err:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms={lib:.4f} bound_ms={bound_ms:.4f} ({bound_by})",
          flush=True)
    _fa_rate(fa.B6, f"zamba2-2.7b D={D} S={S} bf16", ms,
             _fa_flops(1, H, S, D, 0, 4), bound_ms)
    del q, k, v
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phase 9b, 9c: the recurrent families' prefill and serving at full width
# ---------------------------------------------------------------------------
def _kernel_modules():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mlstm_scan as ml
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import pseudo_voigt as pv
    from repro_torch.kernels import ssm_scan as ssd
    return fa, ml, pa, pv, ssd


def _zero_counts() -> None:
    for m in _kernel_modules():
        m.reset_launch_counts()


def _read_counts() -> dict:
    out = {}
    for m in _kernel_modules():
        out.update(m.launch_counts)
    return out


def _logits_gap(a, b) -> tuple:
    """(relative 2-norm, max abs) of the difference of two logit rows."""
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item(), (a - b).abs().max().item()


def _group_prefill(name: str) -> str:
    """Kernel family of a device kernel name in a recurrent prefill."""
    if "ssd" in name:
        return "ssd scan"
    if "flash" in name:
        return "flash attention"
    return _group_train(name)


def _profile_prefill(arch, step, params, batch) -> None:
    """One more kernel prefill under ``torch.profiler``: device time by
    kernel family, the busy time and the idle share of the wall."""
    import torch
    from repro_torch.launch.profile_serve import _busy_us
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        step(params, batch)
        _sync()
    wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _busy_us(kernels) / 1e6
    groups = {"ssd scan": [0.0, 0], "flash attention": [0.0, 0],
              "gemm": [0.0, 0], "other": [0.0, 0]}
    by_name = {}
    for e in kernels:
        ms_e = (e.time_range.end - e.time_range.start) / 1e3
        for acc in (groups[_group_prefill(e.name)],
                    by_name.setdefault(e.name, [0.0, 0])):
            acc[0] += ms_e
            acc[1] += 1
    print(f"{arch} prefill profile [kernel, bf16]: wall_ms={wall * 1e3:.2f} "
          f"device_busy_ms={busy * 1e3:.2f} idle_share="
          f"{1 - busy / wall:.4f} kernels={len(kernels)} " + " ".join(
              f"{g.replace(' ', '_')}_ms={v[0]:.2f} ({v[1]})"
              for g, v in groups.items()), flush=True)
    for name, (t_ms, n) in sorted(by_name.items(),
                                  key=lambda kv: -kv[1][0])[:TOP_KERNELS]:
        print(f"  {t_ms:9.3f} ms {n:5d} calls  {name[:100]}", flush=True)


def phase_recurrent(arch: str, want: dict) -> tuple:
    """``arch`` at its published width and depth, random bf16 weights from
    SEED: the prefill step (``make_prefill_step_fn``, no grad) at batch 1
    and PREFILL_SEQ tokens must launch exactly ``want`` and no other
    kernel; the plain path (``use_kernel=False``) on the same weights and
    tokens must agree on the last position's logits (bf16 steps within
    RECURRENT_BF16_REL_L2; float32 forwards within RECURRENT_F32_REL_L2);
    then ``SlotDecodeEngine`` serves SERVE_REQUESTS requests on
    SERVE_SLOTS slots (so slots are reused) and every request must
    finish.  Returns the prefill's launches and the median wall of its
    PREFILL_TIMED[arch] kernel runs after the first, for phase 17
    (:func:`_measured`)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch.specs import make_prefill_step_fn
    from repro_torch.models.api import build_model
    from repro_torch.serving.engine import DecodeEngine, SlotDecodeEngine
    cfg = get_config(arch)
    api = build_model(cfg)
    t0 = time.perf_counter()
    params = api.init(seed=SEED, device=DEVICE, dtype=torch.bfloat16)
    _sync()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"{arch}: full width (d_model={cfg.d_model}, layers="
          f"{cfg.n_layers}, heads={cfg.n_heads}x{cfg.resolved_head_dim}, "
          f"vocab={cfg.vocab_size}) {n_params / 1e9:.3f} B params bf16 "
          f"(gates and decays float32) in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card",
          flush=True)
    shape = InputShape(f"prefill_{PREFILL_SEQ}", PREFILL_SEQ, 1, "prefill")
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, PREFILL_SEQ),
                                     generator=gen, device=DEVICE)}
    window = api.effective_window(PREFILL_SEQ)
    runs = {}
    with torch.no_grad():
        for label, kw in (("kernel", {}), ("plain", {"use_kernel": False})):
            step = make_prefill_step_fn(api, shape, **kw)
            times = []
            for _ in range(1 + (PREFILL_TIMED[arch] if label == "kernel"
                                else 1)):
                _zero_counts()
                t0 = time.perf_counter()
                out = step(params, batch)
                _sync()
                times.append((time.perf_counter() - t0) * 1e3)
                counts = {k: v for k, v in _read_counts().items() if v}
            runs[label] = out
            ms = statistics.median(times[1:])
            if label == "kernel":
                prefill_ms = ms
            print(f"{arch} prefill [{label}, bf16]: batch 1 x {PREFILL_SEQ} "
                  f"tokens, logits {tuple(out.shape)} {out.dtype} "
                  f"finite={bool(torch.isfinite(out).all())} wall_ms="
                  f"{times[0]:.2f} (first), {ms:.2f} (median of "
                  f"{len(times) - 1}; {PREFILL_SEQ / ms * 1e3:.1f} tokens/s) "
                  f"kernel_launches={json.dumps(counts)}", flush=True)
            expect = want if label == "kernel" else {}
            if counts != expect:
                raise AssertionError(f"{arch} {label} prefill launches "
                                     f"{counts} != {expect}")
            if not bool(torch.isfinite(out).all()) or \
                    tuple(out.shape) != (1, cfg.vocab_size):
                raise AssertionError(f"{arch} {label} prefill logits")
            if label == "kernel" and arch == "zamba2-2.7b":
                _profile_prefill(arch, step, params, batch)
        rel16, max16 = _logits_gap(runs["kernel"], runs["plain"])
        f32 = {}
        for label, kw in (("kernel", {}), ("plain", {"use_kernel": False})):
            logits, _ = api.forward(params, batch["tokens"], window=window,
                                    compute_dtype=torch.float32,
                                    remat=False, **kw)
            f32[label] = logits[:, -1].clone()
            del logits
            torch.cuda.empty_cache()
        rel32, max32 = _logits_gap(f32["kernel"], f32["plain"])
    agree = int((runs["kernel"].argmax(-1) == runs["plain"].argmax(-1)
                 ).sum())
    to32 = {k: _logits_gap(v, f32["kernel"])[0] for k, v in runs.items()}
    lim16 = RECURRENT_BF16_REL_L2[arch]
    print(f"{arch} prefill kernel vs plain, last position: bf16 rel_l2="
          f"{rel16:.3e} max_abs={max16:.3e} (limit rel_l2 {lim16:g}), same "
          f"argmax={agree}; float32 rel_l2={rel32:.3e} max_abs={max32:.3e} "
          f"(limit rel_l2 {RECURRENT_F32_REL_L2:g}); from the float32 "
          f"kernel forward: bf16 kernel rel_l2={to32['kernel']:.3e}, bf16 "
          f"plain rel_l2={to32['plain']:.3e}; max |logit| bf16="
          f"{runs['plain'].float().abs().max().item():.3e}", flush=True)
    if not (rel16 <= lim16 and rel32 <= RECURRENT_F32_REL_L2):
        raise AssertionError(f"{arch}: the kernel prefill disagrees with "
                             "the plain one")
    del runs, f32
    torch.cuda.empty_cache()

    # serving: the slot engine, prompts fed token by token
    rng = np.random.default_rng(SEED)
    eng = DecodeEngine(api, params, n_slots=SERVE_SLOTS, cache_len=64,
                       device=DEVICE)
    if not isinstance(eng, SlotDecodeEngine):
        raise AssertionError(f"{arch} is not served by the slot engine")
    for _ in range(SERVE_REQUESTS):
        eng.submit(rng.integers(0, cfg.vocab_size, 8).astype(np.int32),
                   SERVE_NEW)
    _zero_counts()
    t0 = time.perf_counter()
    finished = eng.run_until_drained()
    _sync()
    wall = time.perf_counter() - t0
    print(f"{arch} serve: SlotDecodeEngine slots={SERVE_SLOTS} "
          f"requests={len(finished)}/{SERVE_REQUESTS} steps={eng.steps} "
          f"tokens={eng.tokens_decoded} wall_s={wall:.3f} tok_per_s="
          f"{eng.tokens_decoded / wall:.2f} ms_per_step="
          f"{wall / eng.steps * 1e3:.2f} kernel_launches="
          f"{json.dumps({k: v for k, v in _read_counts().items() if v})}",
          flush=True)
    if len(finished) != SERVE_REQUESTS or not all(
            len(r.generated) == SERVE_NEW for r in finished):
        raise AssertionError(f"{arch} serve: not every request finished")
    del eng, params
    torch.cuda.empty_cache()
    return want, _measured(f"9 {arch} prefill (median)", cfg, shape,
                           prefill_ms)


def _sync() -> None:
    import torch
    if DEVICE == "cuda":
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# phase 10: the MoE family, the VLM backbone and command-r-35b
# ---------------------------------------------------------------------------
def _init_full(arch: str, dtype_name: str = "bfloat16", **cfg_updates):
    """(api, params): ``arch`` at its published width (``cfg_updates``
    cut it), random weights from SEED in ``dtype_name``; prints the size,
    the time and the card's memory."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    # an engine and its block manager reference each other (the swap
    # callback), so the last model's weights wait for a collection
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(arch), **cfg_updates)
    api = build_model(cfg)
    t0 = time.perf_counter()
    params = api.init(seed=SEED, device=DEVICE,
                      dtype=getattr(torch, dtype_name))
    _sync()
    n = sum(t.numel() for t in _leaves(params))
    print(f"{arch}: d_model={cfg.d_model} layers={cfg.n_layers} heads="
          f"{cfg.n_heads}/{cfg.n_kv_heads}x{cfg.resolved_head_dim} vocab="
          f"{cfg.vocab_size} {n / 1e9:.3f} B params {dtype_name} in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card",
          flush=True)
    return api, params


def _spec_drain(api, params, label, engine_kw, kernel) -> None:
    """Speculative decoding on the path, apart from the timed fleet (in
    which the engine's n-gram proposer seldom finds a match in these
    random models' tokens): two of the fleet's prompts drained with
    ``spec=False``, then again with drafts that replay the first drain's
    greedy tokens, as a draft model that agrees with the target would
    propose them.  Each drain must run through ``kernel`` only (layers x
    steps); the second must verify drafts and accept some (not all need
    be: the draft rows change the batch, and so bf16 rounding and, in an
    MoE, the capacity groups)."""
    from repro_torch.launch.profile_serve import shared_prefix_fleet
    from repro_torch.serving.engine import PagedDecodeEngine
    from repro_torch.serving.spec import Proposer
    cfg = api.cfg
    first, others = shared_prefix_fleet(cfg.vocab_size, SEED)
    greedy = []                      # prompt + spec=False tokens, a request

    class Replay(Proposer):
        def propose(self, tokens, k):
            n = len(tokens)
            for seq in greedy:
                if n < len(seq) and seq[:n] == [int(t) for t in tokens]:
                    return seq[n:n + k]
            return []

    runs = {}
    for spec in (False, True):
        _zero_counts()
        eng = PagedDecodeEngine(api, params, n_slots=8, cache_len=512,
                                window=api.effective_window(512),
                                device=DEVICE, spec=spec,
                                proposer=Replay() if spec else None,
                                **engine_kw)
        for prompt in (first, others[1]):
            eng.submit(prompt, SPEC_NEW)
        done = sorted(eng.run_until_drained(), key=lambda r: r.request_id)
        counts = {k: v for k, v in _read_counts().items() if v}
        s = eng.stats()
        runs[spec] = [list(r.generated) for r in done]
        if not spec:
            greedy.extend([int(t) for t in r.prompt] + list(r.generated)
                          for r in done)
        print(f"speculation [{label}, spec={spec}]: requests={len(done)} "
              f"steps={eng.steps} tokens={eng.tokens_decoded} drafted="
              f"{s['tokens_drafted']} accepted={s['draft_tokens_accepted']} "
              f"verifications={s['spec_verifications']} kernel_launches="
              f"{json.dumps(counts)}", flush=True)
        want = {kernel: cfg.n_layers * eng.steps}
        if counts != want or len(done) != 2 or any(
                len(g) != SPEC_NEW for g in runs[spec]):
            raise AssertionError(f"[{label}] speculation drain: launches "
                                 f"{counts} != {want}, or its requests")
        if spec and not (s["spec_verifications"] > 0
                         and s["draft_tokens_accepted"] > 0):
            raise AssertionError(f"[{label}] no draft verified or accepted")
    same = sum(a == b for x, y in zip(runs[False], runs[True])
               for a, b in zip(x, y))
    print(f"speculation [{label}]: {same}/{2 * SPEC_NEW} tokens as without "
          "drafts", flush=True)


def _serve_paths(api, params, paths) -> dict:
    """For each (label, engine options, kernel) of ``paths``: the fleet
    (``phase_main_path`` with the engine's own proposer, which need not
    draft here), then ``_spec_drain``; every kernel count zeroed just
    before each and read just after: no kernel but the path's read may
    launch.  Returns the fleets' launches."""
    out = {}
    for label, kw, kernel in paths:
        _zero_counts()
        out[label] = phase_main_path(api, params, label, kw, kernel,
                                     speculates=False)
        others = {k: v for k, v in _read_counts().items()
                  if v and k != kernel}
        if others:
            raise AssertionError(f"[{label}] launched {others}")
        _spec_drain(api, params, label, kw, kernel)
    return out


class _RoutePin:
    """Wraps the port's MoE router (``moe.route_topk``) for the phase, so
    that the plain path routes as the kernel path did: on a kernel run
    each call's top-k indices are kept; on the plain run after it, the
    i-th call takes the kernel run's i-th indices, with its own gate
    values at them (its own float32 softmax, renormalised over the k),
    and the capacity bookkeeping follows from them.  Logits then stay
    comparable at any depth, where one flipped route would otherwise move
    its token's later layers, its lane's later tokens and its group's
    capacity slots by O(1).  Either way ``own`` logs each call's own
    top-k, and ``dropped`` counts the (token, choice) pairs of the run's
    routes past their expert's capacity, padding rows included.  A
    replaying run over ``per`` tensor-parallel positions (each routes
    every layer on the same gathered logits, in position order) takes the
    kept run's call i // per at its call i."""

    def __init__(self, mo):
        self.mo, self.kernel, self.own = mo, [], []
        self.replay, self.dropped, self.per = False, 0, 1

    def start(self, use_kernel: bool, per: int = 1) -> None:
        self.replay, self.own, self.dropped = not use_kernel, [], 0
        self.per = per
        if use_kernel:
            self.kernel = []

    def __enter__(self):
        import torch
        from repro_torch.models import moe
        inner = self.inner = moe.route_topk

        def route_topk(logits, k):
            gates, idx = inner(logits, k)
            self.own.append(idx)
            if self.replay:
                idx = self.kernel[(len(self.own) - 1) // self.per]
                gates = torch.softmax(logits.to(torch.float32), -1) \
                    .gather(-1, idx)
                gates = gates / torch.clamp_min(
                    gates.sum(-1, keepdim=True), 1e-9)
            else:
                self.kernel.append(idx)
            G, S, _ = logits.shape
            choice = torch.nn.functional.one_hot(
                idx.reshape(G, S * k), self.mo.n_experts)
            claims = torch.cumsum(choice, 1) - choice
            C = moe.expert_capacity(S, self.mo)
            self.dropped += int(((claims >= C) & (choice > 0)).sum())
            return gates, idx

        moe.route_topk = route_topk
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.route_topk = self.inner


def _moe_steps_vs_plain(api, params, dtype_name: str) -> None:
    """``_step_runs``'s mixed batch, kernel against plain path, the plain
    path routed as the kernel path was (``_RoutePin``): the share of
    (token, MoE layer) whose own top-k set on the plain path differs from
    the kernel path's within MOE_ROUTE_SHARE[dtype_name], and the logits
    of every row within phase 5's gate in float32, within
    MOE_BF16_REL_L2 in bf16."""
    import torch
    mo, E = api.cfg.moe, api.cfg.moe.n_experts
    tag = f"{api.cfg.name} step vs plain [{{}}, {dtype_name}, " \
          f"{api.cfg.n_layers} layers]"
    lim = MOE_ROUTE_SHARE[dtype_name]
    sets = lambda idx: torch.nn.functional.one_hot(idx, E).sum(-2) > 0
    with _RoutePin(mo) as pin:
        for label, T, out in _step_runs(api, params,
                                        dtype=getattr(torch, dtype_name),
                                        routes=pin):
            own_k = torch.stack([sets(t) for t in out[True, "routes"]])
            own_p = torch.stack([sets(t) for t in out[False, "routes"]])
            differ = (own_k != own_p).any(-1)          # (MoE layers, T)
            share = differ.float().mean().item()
            a, b = out[True], out[False]
            err = (a - b).abs().max().item()
            scale = b.abs().max().item()
            rel = ((a - b).norm() / b.norm()).item()
            agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
            finite = bool(torch.isfinite(a).all())
            f32 = dtype_name == "float32"
            tol = ("err <= 0.05 * max_abs_logit, agreement >= 0.9" if f32
                   else f"rel_l2 <= {MOE_BF16_REL_L2:g}")
            print(f"{tag.format(label)}: T={T} logits {tuple(a.shape)} "
                  f"max_abs_err={err:.4f} max_abs_logit={scale:.4f} "
                  f"rel_l2={rel:.4e} argmax_agreement={agree:.4f} (tol: "
                  f"{tol}); routes "
                  f"pinned to the kernel path's, (token, choice) pairs past "
                  f"capacity {pin.dropped}; (token, MoE layer) whose own "
                  f"top-k differs on the plain path {int(differ.sum())}/"
                  f"{differ.numel()}, share {share:.4e} (limit {lim:g}); by "
                  f"MoE layer " + " ".join(
                      f"{x:.3f}" for x in differ.float().mean(1).tolist()),
                  flush=True)
            close = (err <= 0.05 * scale and agree >= 0.9) if f32 else \
                rel <= MOE_BF16_REL_L2
            if not (finite and close and share <= lim):
                raise AssertionError(f"{tag.format(label)} disagrees with "
                                     "the plain path")
            del a, b, out


def phase_moe() -> dict:
    """deepseek-moe-16b at its published width and depth in bf16: the
    shared-prefix fleet and the speculation drains in the three layouts,
    each through its own paged read only (layers x steps); then the mixed
    batch kernel against plain: bf16 at full depth and float32 at
    MOE_F32_LAYERS layers.  Returns the launches by path."""
    import torch
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    api, params = _init_full("deepseek-moe-16b")
    launches = _serve_paths(api, params, [
        (f"deepseek-moe-16b {label}", kw, kernel)
        for label, kw, kernel in PATHS])
    _moe_steps_vs_plain(api, params, "bfloat16")
    print(f"deepseek-moe-16b: peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    del params
    torch.cuda.empty_cache()
    api, params = _init_full("deepseek-moe-16b", "float32",
                             n_layers=MOE_F32_LAYERS)
    _moe_steps_vs_plain(api, params, "float32")
    del params
    torch.cuda.empty_cache()
    print(f"phase 10a-b: {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def phase_vlm() -> dict:
    """llava-next-mistral-7b at its published width, random bf16 weights
    from SEED: the prefill step (``make_prefill_step_fn``, no grad) on
    VLM_PATCHES seeded-normal patch embeddings and VLM_TEXT tokens must
    launch B6 once a layer and no other kernel, and agree with the plain
    path on the last position's logits in bf16 and in float32; then one
    default-layout fleet through the text backbone (B1 only)."""
    import torch
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch.specs import make_prefill_step_fn
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    api, params = _init_full("llava-next-mistral-7b")
    cfg = api.cfg
    S = VLM_PATCHES + VLM_TEXT
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    batch = {"patches": torch.randn((1, VLM_PATCHES, cfg.frontend.d_embed),
                                    generator=gen, device=DEVICE),
             "tokens": torch.randint(0, cfg.vocab_size, (1, VLM_TEXT),
                                     generator=gen, device=DEVICE)}
    shape = InputShape(f"prefill_{S}", S, 1, "prefill")
    window = api.effective_window(S)
    runs, f32 = {}, {}
    with torch.no_grad():
        for label, kw in (("kernel", {}), ("plain", {"use_kernel": False})):
            step = make_prefill_step_fn(api, shape, **kw)
            times = []
            for _ in range(2):
                _zero_counts()
                t1 = time.perf_counter()
                out = step(params, batch)
                _sync()
                times.append((time.perf_counter() - t1) * 1e3)
                counts = {k: v for k, v in _read_counts().items() if v}
            runs[label] = out
            print(f"{cfg.name} prefill [{label}, bf16]: batch 1 x "
                  f"({VLM_PATCHES} patches + {VLM_TEXT} tokens), window "
                  f"{window}, logits {tuple(out.shape)} finite="
                  f"{bool(torch.isfinite(out).all())} wall_ms="
                  f"{times[0]:.2f} (first), {times[1]:.2f} "
                  f"({S / times[1] * 1e3:.1f} positions/s) "
                  f"kernel_launches={json.dumps(counts)}", flush=True)
            expect = {"flash_attention": cfg.n_layers} \
                if label == "kernel" else {}
            if counts != expect or not bool(torch.isfinite(out).all()) \
                    or tuple(out.shape) != (1, cfg.vocab_size):
                raise AssertionError(f"{cfg.name} {label} prefill: launches "
                                     f"{counts} != {expect}, or its logits")
        for label, kw in (("kernel", {}), ("plain", {"use_kernel": False})):
            logits, _ = api.forward(params, batch["tokens"],
                                    patches=batch["patches"], window=window,
                                    compute_dtype=torch.float32,
                                    remat=False, **kw)
            f32[label] = logits[:, -1].clone()
            del logits
            torch.cuda.empty_cache()
    rel16, max16 = _logits_gap(runs["kernel"], runs["plain"])
    rel32, max32 = _logits_gap(f32["kernel"], f32["plain"])
    to32 = {k: _logits_gap(v, f32["kernel"])[0] for k, v in runs.items()}
    print(f"{cfg.name} prefill kernel vs plain, last position: bf16 "
          f"rel_l2={rel16:.3e} max_abs={max16:.3e} (limit {VLM_BF16_REL_L2:g}"
          f"); float32 rel_l2={rel32:.3e} max_abs={max32:.3e} (limit "
          f"{VLM_F32_REL_L2:g}); from the float32 kernel forward: bf16 "
          f"kernel rel_l2={to32['kernel']:.3e}, bf16 plain rel_l2="
          f"{to32['plain']:.3e}; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    if not (rel16 <= VLM_BF16_REL_L2 and rel32 <= VLM_F32_REL_L2):
        raise AssertionError(f"{cfg.name}: the kernel prefill disagrees "
                             "with the plain one")
    del runs, f32
    torch.cuda.empty_cache()
    launches = _serve_paths(api, params, [
        (f"{cfg.name} default (segment-tiled)", {}, "paged_attention_tiled")])
    del params
    torch.cuda.empty_cache()
    print(f"phase 10c: {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def phase_command_r() -> dict:
    """command-r-35b at its published width (parallel block, layernorm,
    tied 256,000-token vocab, 64/8 heads: G 8), random bf16 weights from
    SEED: one default-layout fleet, through B1 only."""
    import torch
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    api, params = _init_full("command-r-35b")
    launches = _serve_paths(api, params, [
        ("command-r-35b default (segment-tiled)", {},
         "paged_attention_tiled")])
    print(f"command-r-35b: peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; phase 10d: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    del params
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 11: the data-center/edge bridge
# ---------------------------------------------------------------------------
# the card as nvidia-smi names it (name, power limit), set by main; every
# line of phases 11 and 12 carries it
CARD = ""
DIS_NEW = 32                  # new tokens a request (phase 4's fleet)
DIS_F32_LAYERS = 4            # 11c: float32 at full width, depth cut
# 11b serves in bf16 with the handoff check off: the DC's prefill batch
# and the edge's tail recompute run GEMMs of other shapes, and on these
# random, near-tied logits a rounding can flip a greedy token.  The
# agreement of the disaggregated run with the one-engine run is gated
# instead: the share of requests whose first token agrees, and of all
# tokens that agree position by position.  The first card reading was
# 8/8 and 256/256 (PERF.md); the limits let one request's first token
# flip, and two requests' tails (a flipped greedy token changes the rest
# of its request: 32 of the 256 tokens)
DIS_BF16_FIRST_AGREE = 7 / 8
DIS_BF16_TOKEN_AGREE = 0.75


def _tag(msg: str) -> None:
    print(f"{msg} [{CARD}]", flush=True)


def phase_bridge_flow() -> dict:
    """11a: the paper's DNNTrainerFlow on the port's ``repro_torch.core``
    at the paper's scale (``launch/remote_retrain_flow.run``: BraggNN at
    its published width, PAPER_PEAKS patches a dataset, 300 steps for v1,
    100 for the warm-started v2, A||T over 8 shards, E on PAPER_PEAKS
    held-out patches).  B7's counts are zeroed just before and read just
    after; each labelling call's launches are counted by wrapping the
    launcher's ``label_for_braggnn``.  Returns B7's launches."""
    import torch
    from repro_torch.kernels import pseudo_voigt as pv
    from repro_torch.launch import remote_retrain_flow as rrf
    t0 = time.perf_counter()
    inner = rrf.label_for_braggnn
    calls = []

    def counted(patches):
        before = pv.launch_counts[pv.PV]
        out = inner(patches)
        calls.append(pv.launch_counts[pv.PV] - before)
        return out

    rrf.label_for_braggnn = counted
    _zero_counts()
    try:
        res = rrf.run(steps=300, peaks=PAPER_PEAKS, device=DEVICE,
                      log=lambda m: _tag(f"bridge flow: {m}"))
    finally:
        rrf.label_for_braggnn = inner
    counts = _nonzero(_read_counts())
    label_errs = [run.output["LabelData"]["result"]["label_err"]
                  for run in (res["v1"], res["v2"])]
    versions = [e.version_tag for e in res["system"].repo.versions("braggnn")]
    err_px = res["edge"]["err_px"]
    br = res["clock"]
    ov = res["overlap"]
    for tag in ("v1", "v2"):
        run = res[tag]
        _tag(f"bridge flow {tag}: status={run.status} turnaround_s="
             f"{run.turnaround:.6f} " + " ".join(
                 f"{e.state}={e.duration:.6f}" for e in run.log))
    _tag(f"bridge flow: clock real_s={br['real']:.6f} modeled_s="
         f"{br['modeled']:.6f} sim_s={br['sim']:.6f} total_s="
         f"{br['total']:.6f}; A||T serial_s={ov['serial_s']:.6f} "
         f"pipelined_s={ov['pipelined_s']:.6f} saving_s="
         f"{ov['saving_s']:.6f}; cost model at {PAPER_PEAKS} peaks "
         + " ".join(f"{k}_s={v:.6f}" for k, v in res["strategies"].items())
         + f" vs the measured v1 turnaround {res['v1'].turnaround:.6f} s")
    _tag(f"bridge flow: pseudo_voigt launches per labelling call {calls}, "
         f"kernel_launches={json.dumps(counts)}, mean |label - truth| "
         f"{label_errs} (limit 0.05), E mean |err| {err_px:.4f} px (limit "
         f"0.5), repository {versions}; phase 11a: "
         f"{time.perf_counter() - t0:.1f} s")
    if not (len(calls) == 10 and calls[0] >= 1 and calls[1] >= 1
            and calls[2:] == [1] * 8 and counts == {pv.PV: sum(calls)}):
        raise AssertionError(f"B7 launches {calls}, {counts}: want >= 1 "
                             "in each LabelData, 8 over A||T, none else")
    if not all(e < 0.05 for e in label_errs) or not err_px < 0.5:
        raise AssertionError(f"labels {label_errs} or E {err_px} px")
    if versions != ["v1", "v2"]:
        raise AssertionError(f"repository holds {versions}")
    del res
    torch.cuda.empty_cache()
    return counts[pv.PV]


def _dis_engine(api, params, **kw):
    """A paged engine of phase 4's shape (8 lanes, 512 tokens, blocks of
    16, the prefix cache on)."""
    from repro_torch.serving.engine import PagedDecodeEngine
    return PagedDecodeEngine(api, params, n_slots=8, cache_len=512,
                             block_size=16, window=api.effective_window(512),
                             device=DEVICE, **kw)


def _count_steps(eng, tally: dict) -> None:
    """Attribute every kernel launched inside ``eng.step`` to ``eng``."""
    inner = eng.step

    def step():
        before = _read_counts()
        out = inner()
        for k, v in _read_counts().items():
            tally[k] = tally.get(k, 0) + v - before.get(k, 0)
        return out

    eng.step = step


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def _same_bits(a, b) -> bool:
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return torch.equal(a.cpu(), b.cpu())


def _check_imports(dis, checked: list) -> None:
    """Wrap the coordinator's export and import: right after each import,
    every block the decode engine took must hold the exported block's
    bytes, bit for bit (counted in ``checked``)."""
    exported = {}
    export, imp = dis.prefill.export_kv_prefix, dis.decode.import_kv_shipment

    def export_and_keep(feed):
        ship = export(feed)
        exported.update({b.digest: b.payload for b in ship.blocks})
        return ship

    def import_and_check(ship):
        stats = imp(ship)
        for rec in ship.blocks:
            if rec.payload is None:
                continue
            blk = dis.decode.kv.digest_block(rec.digest)
            got = dis.decode._read_block_payload(blk)
            want = exported[rec.digest]
            if set(got) != set(want) or not all(
                    _same_bits(got[p][n], want[p][n])
                    for p in want for n in want[p]):
                raise AssertionError(f"imported block {rec.digest[:12]} "
                                     "differs from the exported one")
            checked.append(rec.digest)
        return stats

    dis.prefill.export_kv_prefix = export_and_keep
    dis.decode.import_kv_shipment = import_and_check


def _one_engine_fleet(api, params, prompts, label):
    """The fleet through one engine (all requests submitted at once), its
    counts zeroed just before and read just after: (tokens by request,
    wall s, engine)."""
    import torch
    eng = _dis_engine(api, params)
    for p in prompts:
        eng.submit(p, DIS_NEW)
    _zero_counts()
    _sync()
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    _sync()
    wall = time.perf_counter() - t0
    counts = _nonzero(_read_counts())
    want = {"paged_attention_tiled": api.cfg.n_layers * eng.steps}
    _tag(f"bridge [{label}] one engine: {len(done)} requests, {eng.steps} "
         f"steps, wall_s={wall:.6f}, kernel_launches={json.dumps(counts)}")
    if counts != want:
        raise AssertionError(f"[{label}] one engine launched {counts} != "
                             f"{want}")
    return {r.request_id: list(r.generated) for r in done}, wall, eng


def _disaggregated_fleet(api, params, prompts, label, base, base_wall,
                         check_handoff: bool):
    """The fleet through ``DisaggregatedEngine`` ("dc" and "edge" share
    the weights): launches by engine (B1 only, layers x that engine's
    steps), imported blocks bit for bit as exported, the shared system
    prompt shipped once.  Returns (coordinator, token agreement with the
    one-engine run: (first tokens, all tokens))."""
    import torch
    from repro_torch.serving.transfer import DisaggregatedEngine
    dis = DisaggregatedEngine(_dis_engine(api, params),
                              _dis_engine(api, params),
                              check_handoff=check_handoff)
    tallies = ({}, {})
    _count_steps(dis.prefill, tallies[0])
    _count_steps(dis.decode, tallies[1])
    checked = []
    _check_imports(dis, checked)
    for p in prompts:
        dis.submit(p, DIS_NEW)
    _zero_counts()
    _sync()
    t0 = time.perf_counter()
    done = dis.run_until_drained()
    wall = time.perf_counter() - t0
    counts = _nonzero(_read_counts())
    got = {r.request_id: list(r.generated) for r in done}
    first = sum(got[i][:1] == base[i][:1] for i in base) / len(base)
    same = sum(a == b for i in base for a, b in zip(got[i], base[i]))
    total = sum(len(base[i]) for i in base)
    s = dis.stats()
    _tag(f"bridge [{label}] disaggregated: wall_s={wall:.6f} "
         f"first-token agreement {first:.4f}, tokens {same}/{total}, "
         f"handoff check {'on' if check_handoff else 'off'}; dc steps "
         f"{dis.prefill.steps} launches {json.dumps(_nonzero(tallies[0]))}, "
         f"edge steps {dis.decode.steps} launches "
         f"{json.dumps(_nonzero(tallies[1]))}; "
         f"{len(checked)} imported blocks bit-exact")
    _tag(f"bridge [{label}] stats: {json.dumps(s)}")
    t_paper = dis.priced_turnaround(1.25e9)
    t_fast = dis.priced_turnaround(12.5e9)
    xo = dis.crossover_bandwidth(base_wall)
    _tag(f"bridge [{label}] priced turnaround at 1.25 GB/s "
         f"{json.dumps(t_paper)}, at 12.5 GB/s {json.dumps(t_fast)}; "
         f"crossover bandwidth against the one-engine wall "
         f"{base_wall:.6f} s: {xo if xo is None else f'{xo:.6g} B/s'}")
    L = api.cfg.n_layers
    for eng, tally, side in ((dis.prefill, tallies[0], "dc"),
                             (dis.decode, tallies[1], "edge")):
        want = {"paged_attention_tiled": L * eng.steps}
        if _nonzero(tally) != want:
            raise AssertionError(f"[{label}] {side} launched {tally} != "
                                 f"{want}")
    if counts != {"paged_attention_tiled": L * (dis.prefill.steps
                                                + dis.decode.steps)}:
        raise AssertionError(f"[{label}] launches outside the steps: "
                             f"{counts}")
    if not (len(done) == len(prompts) and checked
            and len(checked) == s["blocks_imported"]
            and s["blocks_dedup_skipped"] > 0
            and s["bytes_shipped"] < s["bytes_naive"]):
        raise AssertionError(f"[{label}] requests, imports or dedup: {s}")
    return dis, (first, same / total)


def _int8_round_trip(api, params, prompt) -> None:
    """11d: an int8-pool shipment (k, v, k_scale, v_scale) serialized,
    deserialized and imported into a second int8 engine, bit for bit."""
    import torch
    from repro_torch.serving.transfer import KVShipment
    src, dst = (_dis_engine(api, params, cache_dtype=torch.int8)
                for _ in range(2))
    src.submit(prompt, 1)
    _zero_counts()
    src.run_until_drained()
    counts = _nonzero(_read_counts())
    if counts != {"paged_attention_tiled": api.cfg.n_layers * src.steps}:
        raise AssertionError(f"int8 prefill launched {counts}")
    ship = src.export_kv_prefix(prompt)
    data = ship.serialize()
    back = KVShipment.deserialize(data)
    stats = dst.import_kv_shipment(back)
    bad = 0
    for rec in ship.blocks:
        got = dst._read_block_payload(dst.kv.digest_block(rec.digest))
        bad += sum(not _same_bits(got[p][n], rec.payload[p][n])
                   for p in rec.payload for n in rec.payload[p])
    names = sorted(ship.blocks[0].payload["scan"])
    _tag(f"bridge int8: {ship.n_blocks} blocks, arrays {names}, "
         f"{len(data)} wire bytes, import {json.dumps(stats)}, "
         f"{bad} arrays differ")
    if names != ["k", "k_scale", "v", "v_scale"] or bad or \
            stats["imported"] != ship.n_blocks:
        raise AssertionError("int8 shipment did not round-trip bit-exact")


def phase_bridge_bf16() -> tuple:
    """11b and 11d's int8 shipment: gemma-7b through
    ``DisaggregatedEngine`` at full width in bf16, all 28 layers, the
    handoff check off, agreement with one engine gated; then int8 pools'
    shipment round trip on the same weights.  Returns (api, params, the
    fleet's prompts, the one-engine run's tokens by request, its wall),
    which phase 12b serves on."""
    import torch
    from repro_torch.launch.profile_serve import shared_prefix_fleet
    t0 = time.perf_counter()
    api, params = _init_full("gemma-7b")
    # after the init, whose collection frees the last phase's weights
    torch.cuda.reset_peak_memory_stats()
    first, others = shared_prefix_fleet(api.cfg.vocab_size, SEED)
    prompts = [first] + others
    base, base_wall, _ = _one_engine_fleet(api, params, prompts, "bf16")
    _, (agree1, agree) = _disaggregated_fleet(
        api, params, prompts, "bf16", base, base_wall, check_handoff=False)
    if agree1 < DIS_BF16_FIRST_AGREE or agree < DIS_BF16_TOKEN_AGREE:
        raise AssertionError(f"bf16 agreement {agree1:.4f} / {agree:.4f} "
                             f"below {DIS_BF16_FIRST_AGREE} / "
                             f"{DIS_BF16_TOKEN_AGREE}")
    _int8_round_trip(api, params, first)
    _tag(f"phase 11b: {time.perf_counter() - t0:.1f} s, peak "
         f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return api, params, prompts, base, base_wall


def phase_bridge_f32() -> tuple:
    """11c and 11d's persistence: the same in float32 cut to
    DIS_F32_LAYERS layers, the handoff check on, every token the
    one-engine run's; then the edge engine's snapshot loaded by a fresh
    engine, whose warm prompt hits the cache with the one-engine tokens.
    Returns what :func:`phase_bridge_bf16` does."""
    import os
    import tempfile
    import torch
    from repro_torch.launch.profile_serve import shared_prefix_fleet
    t0 = time.perf_counter()
    api, params = _init_full("gemma-7b", "float32",
                             n_layers=DIS_F32_LAYERS)
    first, others = shared_prefix_fleet(api.cfg.vocab_size, SEED)
    prompts = [first] + others
    base, base_wall, _ = _one_engine_fleet(api, params, prompts, "f32")
    dis, (agree1, agree) = _disaggregated_fleet(
        api, params, prompts, "f32", base, base_wall, check_handoff=True)
    if agree1 != 1.0 or agree != 1.0:
        raise AssertionError("float32 disaggregated tokens differ from the "
                             "one-engine run's")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "prefix.kvship")
        nbytes = dis.decode.save_prefix_cache(path)
        fresh = _dis_engine(api, params)
        loaded = fresh.load_prefix_cache(path)
    fresh.submit(first, DIS_NEW)
    _zero_counts()
    warm = list(fresh.run_until_drained()[0].generated)
    counts = _nonzero(_read_counts())
    s = fresh.stats()
    _tag(f"bridge persistence: snapshot {nbytes} B, loaded "
         f"{json.dumps(loaded)}, warm prompt prefix_hits="
         f"{s['prefix_hits']} prefix_tokens_reused="
         f"{s['prefix_tokens_reused']}, tokens as the one-engine run: "
         f"{warm == base[0]}")
    if not (s["prefix_hits"] > 0 and warm == base[0]) or counts != {
            "paged_attention_tiled": api.cfg.n_layers * fresh.steps}:
        raise AssertionError("the restarted engine missed its cache, "
                             f"changed the tokens or launched {counts}")
    del dis, fresh
    torch.cuda.empty_cache()
    _tag(f"phase 11c-d: {time.perf_counter() - t0:.1f} s")
    return api, params, prompts, base, base_wall


# ---------------------------------------------------------------------------
# phase 12: the paper's second DNN and the online frontend
# ---------------------------------------------------------------------------
# the reference's CookieNetAE dataset, DATASET_BYTES["cookienetae"] =
# 3.2 GB (benchmarks/bench_table1.py), at 16,384 B a shot (a 16 x 128
# float32 image and its pdf)
COOKIE_SHOTS = 195_312
COOKIE_HELD = 8_192           # held-out shots for the MSE gate
COOKIE_BATCH = 64
# the trained weights' forward on the card against the same forward on
# the CPU, both float32 without TF32: relative 2-norm
COOKIE_CARD_CPU_REL_L2 = 1e-5
FE_LOAD = 0.25                # light load, a share of the capacity C
# the overload's TTFT target: far below one step (~40 ms at full width),
# but above the ~0.1 ms from a step's start to its admission, so the
# first request is admitted (and then cancelled by the harness) and
# every other one is shed once it has waited a step
FE_OVERLOAD_TTFT = 1e-3
FE_CANCEL_AFTER = 1e-6        # the overload's first request: cancelled
FE_DISCONNECT, FE_DISCONNECT_AFTER = 3, 4   # the consumer, its tokens
FE_WAIT_S = 120               # every wait on the step thread


def phase_cookienetae() -> None:
    """12a: CookieNetAE through the paper's Table-1 flow on the card, in
    float32 (``remote_retrain_flow.run_cookienetae``): COOKIE_SHOTS
    simulated shots as 10 files, TransferData, TrainModel (300
    ``adam(1e-3)`` steps at batch 64 on the published width),
    TransferModel, RegisterModel as v1.  Gates: the run succeeded, the
    repository holds v1, the last loss is at most 0.8 of the first, the
    trained model's MSE on COOKIE_HELD held-out shots is below the
    untrained one's, and its forward on the card matches the CPU's."""
    import torch
    from repro_torch.configs import CookieNetAEConfig
    from repro_torch.data.synthetic import cookiebox_shots
    from repro_torch.launch import remote_retrain_flow as rrf
    from repro_torch.models import cookienetae
    t0 = time.perf_counter()
    _tag(f"cookienetae: float32, torch.backends.cudnn.allow_tf32="
         f"{torch.backends.cudnn.allow_tf32} "
         f"torch.backends.cuda.matmul.allow_tf32="
         f"{torch.backends.cuda.matmul.allow_tf32}")
    cfg = CookieNetAEConfig()
    torch.cuda.reset_peak_memory_stats()
    res = rrf.run_cookienetae(steps=300, shots=COOKIE_SHOTS, device=DEVICE,
                              log=lambda m: _tag(f"cookienetae flow: {m}"))
    run, sys_ = res["run"], res["system"]
    br = sys_.clock.breakdown()
    versions = [e.version_tag for e in sys_.repo.versions("cookienetae")]
    params = sys_.repo.latest("cookienetae").artifact.payload
    steps = run.output["TrainModel"]["result"]["steps"]
    _tag(f"cookienetae flow v1: status={run.status} turnaround_s="
         f"{run.turnaround:.6f} " + " ".join(
             f"{e.state}={e.duration:.6f}" for e in run.log)
         + f"; clock real_s={br['real']:.6f} modeled_s={br['modeled']:.6f}"
         f" sim_s={br['sim']:.6f} total_s={br['total']:.6f}; S "
         f"{COOKIE_SHOTS} shots ({res['dataset_bytes']} B) in "
         f"{res['simulate_s']:.6f} s = "
         f"{COOKIE_SHOTS / res['simulate_s']:.6e} shots/s; T {steps} steps "
         f"in {res['train_s']:.6f} s = {res['train_s'] / steps * 1e3:.4f} "
         f"ms/step; loss first {res['first_loss']:.6e} last "
         f"{res['final_loss']:.6e}; repository {versions}")
    if run.status != "SUCCEEDED" or versions != ["v1"]:
        raise AssertionError(f"cookienetae flow {run.status}, {versions}")
    if not res["final_loss"] <= rrf.COOKIE_LOSS_RATIO * res["first_loss"]:
        raise AssertionError(f"loss {res['first_loss']} -> "
                             f"{res['final_loss']}")

    # held-out shots: the trained and the untrained model's MSE
    g = torch.Generator(device=DEVICE)
    g.manual_seed(SEED + 12)
    held = cookiebox_shots(g, COOKIE_HELD, device=DEVICE)
    untrained = cookienetae.init_params(cfg, seed=0, device=DEVICE)

    def mse(p):
        with torch.no_grad():
            return sum(float(cookienetae.loss_fn(p, {
                k: v[lo:lo + 1024] for k, v in held.items()}, cfg)[0])
                for lo in range(0, COOKIE_HELD, 1024)) / (COOKIE_HELD / 1024)

    trained_mse, untrained_mse = mse(params), mse(untrained)
    x = held["images"][:COOKIE_BATCH]
    with torch.no_grad():
        card = cookienetae.forward(params, x, cfg)
        cpu = cookienetae.forward({k: v.cpu() for k, v in params.items()},
                                  x.cpu(), cfg)
        fwd_ms = _median_ms(lambda: cookienetae.forward(params, x, cfg),
                            reps=5)
    rel = float((card.cpu() - cpu).norm() / cpu.norm())
    flops = 2 * COOKIE_BATCH * cfg.channels * cfg.bins * (
        cookienetae.N_PARAMS - sum(c for _, _, c in cookienetae._STACK))
    _tag("cookienetae forward by layer: " + _conv_layer_times(
        params, x, cookienetae._STACK))
    _tag(f"cookienetae: held-out MSE over {COOKIE_HELD} shots trained "
         f"{trained_mse:.6e} untrained {untrained_mse:.6e}; forward of a "
         f"batch of {COOKIE_BATCH} {fwd_ms:.4f} ms "
         f"({flops / fwd_ms / 1e9:.2f} TFLOP/s), card vs CPU rel_l2 "
         f"{rel:.3e} (limit {COOKIE_CARD_CPU_REL_L2}); peak "
         f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; phase 12a: "
         f"{time.perf_counter() - t0:.1f} s")
    if not trained_mse < untrained_mse:
        raise AssertionError(f"held-out MSE {trained_mse} not below the "
                             f"untrained {untrained_mse}")
    if not rel <= COOKIE_CARD_CPU_REL_L2:
        raise AssertionError(f"card vs CPU forward rel_l2 {rel}")
    del res, sys_, params, held
    torch.cuda.empty_cache()


def _conv_layer_times(params, x, stack) -> str:
    """Each of CookieNetAE's convolutions on its own, at the forward's
    shapes: ms and TFLOP/s with cuDNN's default algorithm choice (what
    the path runs) and, for comparison only, with
    ``torch.backends.cudnn.benchmark`` on."""
    import torch
    import torch.nn.functional as F
    parts = []
    with torch.no_grad():
        h = x.permute(0, 3, 1, 2)
        for i, (k, cin, cout) in enumerate(stack):
            w, b = params[f"conv{i}_w"], params[f"conv{i}_b"]

            def conv(h=h, w=w, b=b, k=k):
                return F.conv2d(h, w, b, padding=k // 2)

            flops = 2 * h.shape[0] * h.shape[2] * h.shape[3] * w.numel()
            ms = _median_ms(conv, reps=5)
            default = torch.backends.cudnn.benchmark
            torch.backends.cudnn.benchmark = True
            try:
                ms_bench = _median_ms(conv, reps=5)
            finally:
                torch.backends.cudnn.benchmark = default
            parts.append(f"conv{i} {cin}->{cout} {k}x{k} {ms:.4f} ms "
                         f"{flops / ms / 1e9:.2f} TFLOP/s (benchmark "
                         f"{ms_bench:.4f} ms)")
            h = torch.relu(conv())
    return "; ".join(parts)


def _open_loop_line(label, out, wall) -> None:
    import torch
    _tag(f"frontend [{label}]: offered_rps={out['offered_rps']:.6f} "
         f"goodput_rps={out['goodput_rps']:.6f} goodput_ratio="
         f"{out['goodput_ratio']:.4f} completed={out['completed']} shed="
         f"{out['shed']} cancelled={out['cancelled']} ttft_p50_s="
         f"{out['ttft_p50']} ttft_p95_s={out['ttft_p95']} makespan_s="
         f"{out['makespan']:.6f} steps={out['steps']} wall_s={wall:.6f} "
         f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def _agreement(got: dict, base: dict) -> tuple:
    """(share of requests whose first token agrees, share of all tokens
    that agree position by position) with the closed-loop drain."""
    first = sum(got.get(i, [])[:1] == base[i][:1] for i in base) / len(base)
    same = sum(a == b for i in base for a, b in zip(got.get(i, []), base[i]))
    return first, same / sum(len(base[i]) for i in base)


def _b1_only(label, steps: int, L: int) -> dict:
    counts = _nonzero(_read_counts())
    if counts != {"paged_attention_tiled": L * steps}:
        raise AssertionError(f"[{label}] launched {counts}, not B1 "
                             f"{L} x {steps}")
    return counts


def _light_load(api, params, prompts, base, base_wall, label,
                exact: bool) -> None:
    """12b steps 1-2: the closed-loop drain's wall W gives the capacity
    C = n / W; the fleet arrives at seeded exponential gaps at FE_LOAD C
    through ``run_open_loop`` on a SimClock."""
    import numpy as np
    import torch
    from repro_torch.core.simclock import SimClock
    from repro_torch.serving.frontend import OpenRequest, run_open_loop
    n, L = len(prompts), api.cfg.n_layers
    cap = n / base_wall
    gaps = np.random.default_rng(SEED + 12).exponential(
        1.0 / (FE_LOAD * cap), n)
    eng = _dis_engine(api, params)
    toks = {}
    eng.on_token = lambda rid, tok, fin: toks.setdefault(rid, []).append(tok)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    out = run_open_loop(eng, [OpenRequest(p, DIS_NEW, t_arrival=float(t))
                              for p, t in zip(prompts, np.cumsum(gaps))],
                        clock=SimClock())
    wall = time.perf_counter() - t0
    counts = _b1_only(f"{label} light", out["steps"], L)
    first, agree = _agreement(toks, base)
    _tag(f"frontend [{label}] calibration: closed-loop drain of {n} "
         f"requests W={base_wall:.6f} s, capacity C={cap:.6f} req/s; "
         f"light load at {FE_LOAD} C: kernel_launches={json.dumps(counts)}, "
         f"tokens vs the drain: first {first:.4f}, all {agree:.4f}")
    _open_loop_line(f"{label} light", out, wall)
    if not (out["completed"] == n and out["goodput_ratio"] == 1.0
            and all(r["status"] == "ok" for r in out["records"])):
        raise AssertionError(f"[{label}] light load: {out['records']}")
    if exact and (first, agree) != (1.0, 1.0):
        raise AssertionError(f"[{label}] open-loop tokens differ")
    if first < DIS_BF16_FIRST_AGREE or agree < DIS_BF16_TOKEN_AGREE:
        raise AssertionError(f"[{label}] agreement {first} / {agree}")


def _overload(api, params, prompts, label) -> None:
    """12b step 3: the whole fleet at t = 0 on one lane, a TTFT target
    no waiting request meets, the first request cancelled by the
    harness: the shed, the cancel and the books."""
    import torch
    from repro_torch.core.simclock import SimClock
    from repro_torch.serving.engine import PagedDecodeEngine
    from repro_torch.serving.frontend import OpenRequest, run_open_loop
    n = len(prompts)
    eng = PagedDecodeEngine(api, params, n_slots=1, cache_len=512,
                            block_size=16, window=api.effective_window(512),
                            device=DEVICE)
    reqs = [OpenRequest(p, DIS_NEW, t_arrival=0.0,
                        cancel_after=FE_CANCEL_AFTER if i == 0 else None)
            for i, p in enumerate(prompts)]
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    out = run_open_loop(eng, reqs, clock=SimClock(),
                        ttft_target=FE_OVERLOAD_TTFT)
    wall = time.perf_counter() - t0
    counts = _b1_only(f"{label} overload", out["steps"], api.cfg.n_layers)
    _open_loop_line(f"{label} overload, ttft_target {FE_OVERLOAD_TTFT} s",
                    out, wall)
    _tag(f"frontend [{label} overload]: engine shed={eng.shed} cancelled="
         f"{eng.cancelled}, kernel_launches={json.dumps(counts)}")
    if not (out["shed"] >= 1 and out["cancelled"] == 1
            and out["completed"] + out["shed"] + out["cancelled"] == n
            and eng.shed == out["shed"]):
        raise AssertionError(f"[{label}] overload books: {out}")
    if eng.scheduler.running or eng.scheduler.waiting:
        raise AssertionError(f"[{label}] overload left work on the engine")


def _async_streams(api, params, prompts, base, label, exact: bool) -> None:
    """12b step 4: every prompt through one ``AsyncEngine.stream``
    consumer in one asyncio loop (prefix cache off); consumer
    FE_DISCONNECT disconnects after FE_DISCONNECT_AFTER tokens."""
    import asyncio
    import numpy as np
    import torch
    from repro_torch.serving.frontend import AsyncEngine
    eng = _dis_engine(api, params, prefix_cache=False)
    tickets = []

    class Frontend(AsyncEngine):
        """Keeps every ticket ``stream`` makes, in submission order."""

        def submit(self, *args, **kwargs):
            tickets.append(super().submit(*args, **kwargs))
            return tickets[-1]

    async def serve(fe):
        async def consume(i):
            toks = []
            async for tok in fe.stream(prompts[i], DIS_NEW):
                toks.append(tok)
                if i == FE_DISCONNECT and len(toks) >= FE_DISCONNECT_AFTER:
                    break            # disconnect: the generator closes
            return toks
        return await asyncio.wait_for(asyncio.gather(
            *(consume(i) for i in range(len(prompts)))), FE_WAIT_S)

    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    with Frontend(eng) as fe:
        streamed = asyncio.run(serve(fe))
        results = [fe.result(t, timeout=FE_WAIT_S) for t in tickets]
    wall = time.perf_counter() - t0
    counts = _b1_only(f"{label} async", fe.steps, api.cfg.n_layers)
    survivors = [i for i in range(len(prompts)) if i != FE_DISCONNECT]
    cut = streamed[FE_DISCONNECT]
    first, agree = _agreement({i: streamed[i] for i in survivors},
                              {i: base[i] for i in survivors})
    _tag(f"frontend [{label} async]: {len(prompts)} stream consumers, "
         f"consumer {FE_DISCONNECT} disconnected after {len(cut)} tokens "
         f"(its request emitted {len(results[FE_DISCONNECT].generated)}); "
         f"cancelled={eng.cancelled} steps={fe.steps} wall_s={wall:.6f} "
         f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
         f"blocks_allocated={eng.kv.allocator.num_allocated} "
         f"kernel_launches={json.dumps(counts)}; survivors vs the drain: "
         f"first {first:.4f}, all {agree:.4f}")
    if not all(np.array_equal(t.prompt, p) for t, p in zip(tickets, prompts)):
        raise AssertionError("the streams submitted out of order")
    if not (eng.cancelled == 1 and results[FE_DISCONNECT].cancelled
            and len(cut) == FE_DISCONNECT_AFTER
            and list(results[FE_DISCONNECT].generated[:len(cut)]) == cut):
        raise AssertionError(f"[{label}] the disconnect: {cut}")
    if not all(streamed[i] == list(results[i].generated)
               and not results[i].cancelled for i in survivors):
        raise AssertionError(f"[{label}] streamed tokens differ from the "
                             "requests' own")
    if eng.kv.allocator.num_allocated != 0:
        raise AssertionError(f"[{label}] blocks left after the drain")
    if exact and ((first, agree) != (1.0, 1.0)
                  or cut != base[FE_DISCONNECT][:len(cut)]):
        raise AssertionError(f"[{label}] streamed tokens differ from the "
                             "drain's")


def _leak_probe(api, params) -> None:
    """12b step 5: ``bench_serving._open_loop_leak_probe``'s shape at full
    width: a fresh host-swap engine whose pool is below the working set,
    five requests sharing a block, all cancelled after 6 steps."""
    import numpy as np
    from repro_torch.serving.engine import PagedDecodeEngine
    bs, cache_len = 8, 64
    rng = np.random.default_rng(13)
    shared = rng.integers(0, api.cfg.vocab_size, bs).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(
        0, api.cfg.vocab_size, 6).astype(np.int32)]) for _ in range(5)]
    need = max(-(-(len(p) + 32) // bs) for p in prompts)
    eng = PagedDecodeEngine(api, params, n_slots=3, cache_len=cache_len,
                            block_size=bs, chunk_tokens=bs, prefix_cache=True,
                            host_swap=True, num_blocks=need + 3,
                            device=DEVICE)
    _zero_counts()
    for p in prompts:                 # max_new large: nothing finishes
        eng.submit(p, 32)
    for _ in range(6):
        eng.step()
    for rid in range(len(prompts)):
        eng.cancel(rid)
    counts = _b1_only("leak probe", eng.steps, api.cfg.n_layers)
    tiers = {"blocks_allocated": int(eng.kv.allocator.num_allocated),
             "prefix_cache_entries": len(eng.kv._cached),
             "host_tier_entries": len(eng._host_tier),
             "queued_swap_ins": len(eng.kv.take_swap_ins())}
    s = eng.stats()
    _tag(f"frontend leak probe: {json.dumps(tiers)}, cancelled="
         f"{s['cancelled']} released_seqs={s['released_seqs']} preemptions="
         f"{s['preemptions']} host_purged={s['host_purged']}, "
         f"kernel_launches={json.dumps(counts)}")
    if eng.has_work() or any(tiers.values()):
        raise AssertionError(f"the leak probe leaked: {tiers}")


def phase_frontend(api, params, prompts, base, base_wall, label,
                   exact: bool) -> None:
    """12b on phase 11's weights and fleet: light load through
    ``run_open_loop`` and the ``AsyncEngine`` streams, each through B1
    only (layers x steps); in bf16 (``exact`` False: the schedule
    differs from the drain's, so the agreement is gated as 11b gates the
    handoff) also the overload and the leak probe; in float32 (``exact``)
    the light load and the streams must give the drain's tokens."""
    t0 = time.perf_counter()
    _light_load(api, params, prompts, base, base_wall, label, exact)
    if not exact:
        _overload(api, params, prompts, label)
    _async_streams(api, params, prompts, base, label, exact)
    if not exact:
        _leak_probe(api, params)
    _tag(f"phase 12b [{label}]: {time.perf_counter() - t0:.1f} s")


def phase_crossover() -> None:
    """12c: ``launch/crossover_analysis.run`` on the card: its stage 2
    (gemma-7b's smoke config in float32, B1's FMA kernel) must give the
    one-engine run's tokens through the split."""
    from repro_torch.launch import crossover_analysis
    t0 = time.perf_counter()
    _zero_counts()
    res = crossover_analysis.run(device=DEVICE, log=lambda m: _tag(
        f"crossover: {m.lstrip(chr(10))}"))
    counts = _nonzero(_read_counts())
    _tag(f"crossover: stage 2 tokens identical {res['split'] == res['local']}"
         f", kernel_launches={json.dumps(counts)}; phase 12c: "
         f"{time.perf_counter() - t0:.1f} s")
    if res["split"] != res["local"] or set(counts) != {
            "paged_attention_tiled"}:
        raise AssertionError(f"crossover stage 2: {counts}")


# each kernel, its source in csrc/ on the main path (bf16: the flash
# kernels', the three paged reads' and the two scans' tensor-core sources)
# and the TPU kernel it replaces
# ---------------------------------------------------------------------------
# phase 13: the audio family and the recurrent families' training
# ---------------------------------------------------------------------------
# whisper-base at its published width: WHISPER_STEPS training steps at
# batch WHISPER_BATCH x (1500 frames, 448 tokens); its prefill at batch
# WHISPER_PREFILL_BATCH; WHISPER_DECODE float32 decode steps against the
# forward; the slot engine on WHISPER_SERVE
WHISPER_BATCH = 8
WHISPER_STEPS = 10
WHISPER_PREFILL_BATCH = 4
WHISPER_DECODE = 32
WHISPER_SERVE = (8, 32, 4)    # requests, new tokens each, slots
# the kernel and plain paths of whisper's first training step in bf16
# (relative differences), its float32 decode against its forward and its
# prefill's last-position logits, kernel against plain (relative 2-norms;
# the bf16 prefill rounded to bf16 as the step returns it, the float32
# forward not rounded).  Limits about 10x the first card run's readings:
# loss 3.57e-6, gradient norm 5.60e-4 (attention's bf16 roundings differ
# on the two paths), decode 3.55e-7, prefill 2.06e-3 and 1.71e-7 (PERF.md)
WHISPER_TRAIN_RTOL = {"loss": 3.5e-5, "grad_norm": 5e-3}
WHISPER_DECODE_REL_L2 = 4e-6
WHISPER_PREFILL_REL_L2 = {"bfloat16": 2e-2, "float32": 2e-6}
# the recurrent families' training (sequence, steps); the depth is the
# deepest whole number of segments whose reckoned footprint fits the card
RECURRENT_TRAIN = {"zamba2-2.7b": (2048, 5), "xlstm-1.3b": (512, 3)}
# (33 B: phase 8b's 58.75 GiB over 1.894 B parameters; 12 B: AdamW's
# float32 temporaries on the largest leaf; the margin: what the CUDA
# context and the allocator keep)
BYTES_PER_PARAM = 33
UPDATE_TEMP_BYTES = 12
CARD_MARGIN = 4 * 2**30


def _recurrent_counts(cfg) -> tuple:
    """(parameters outside the layer stack, parameters a layer, elements of
    the largest stacked leaf a layer) of zamba2 or xLSTM at ``cfg``'s
    widths, from the shapes ``models/ssm.py``, ``models/xlstm.py`` and
    ``models/recurrent.py`` give them: zamba2's layer is a Mamba2 block
    and its norm (its largest leaf ``w_in``), the shared block counted
    outside the stack; xLSTM's is a segment's 7 mLSTM and one sLSTM
    blocks over its 8 layers (the largest leaf ``wq``)."""
    from repro_torch.models import ssm, xlstm
    d, V = cfg.d_model, cfg.vocab_size
    head = 2 * V * d + (d if cfg.norm_type == "rmsnorm" else 2 * d)
    if cfg.ssm is not None:
        dm = ssm.dims(cfg)
        d_in, H, N, G, K = dm["d_inner"], dm["H"], dm["N"], dm["G"], dm["K"]
        conv = d_in + 2 * G * N
        w_in = d * (2 * d_in + 2 * G * N + H)
        layer = w_in + K * conv + conv + 3 * H + d_in + d_in * d + d
        gated = cfg.mlp_type in ("swiglu", "geglu")
        shared = (4 * d * cfg.n_heads * cfg.resolved_head_dim
                  + (3 if gated else 2) * d * cfg.d_ff + 2 * d)
        return head + shared, layer, w_in
    dm = xlstm.mlstm_dims(cfg)
    d_in, H, K = dm["d_in"], dm["H"], cfg.xlstm.conv1d_kernel
    mlstm = (2 * d + 3 * d * d_in + K * d_in + d_in + 3 * d_in * d_in
             + 2 * d_in * H + 2 * H + d_in)
    ff = int(d * cfg.xlstm.slstm_proj_factor)
    slstm = 4 * d * d + 4 * d * d // cfg.n_heads + 10 * d + 3 * d * ff
    per = cfg.xlstm.slstm_every
    return (head, ((per - 1) * mlstm + slstm) / per,
            (per - 1) * d_in * d_in / per)


def _depth_cut(arch: str) -> tuple:
    """(layers, the reckoning as text, parameters at that depth): the
    deepest multiple of ``arch``'s segment length whose footprint,
    BYTES_PER_PARAM a parameter plus UPDATE_TEMP_BYTES an element of the
    largest leaf, fits the card's memory less CARD_MARGIN."""
    import torch
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    per = cfg.hybrid_attn_every or cfg.xlstm.slstm_every
    fixed, layer, leaf = _recurrent_counts(cfg)
    budget = torch.cuda.get_device_properties(0).total_memory - CARD_MARGIN

    def need(L):
        return (BYTES_PER_PARAM * (fixed + L * layer)
                + UPDATE_TEMP_BYTES * L * leaf)

    L = cfg.n_layers
    while L > per and need(L) > budget:
        L -= per
    text = (f"{arch}: {fixed + cfg.n_layers * layer:,.0f} parameters at its "
            f"{cfg.n_layers} layers ({fixed:,.0f} outside the stack, "
            f"{layer:,.0f} a layer); reckoned {BYTES_PER_PARAM} B a "
            f"parameter (phase 8b) + {UPDATE_TEMP_BYTES} B an element of the "
            f"largest leaf: {need(cfg.n_layers) / 2**30:.2f} GiB at full "
            f"depth, {need(L) / 2**30:.2f} GiB at {L} layers, against "
            f"{budget / 2**30:.2f} GiB (the card less "
            f"{CARD_MARGIN / 2**30:.0f} GiB): depth cut to {L} of "
            f"{cfg.n_layers} layers")
    return L, text, fixed + L * layer


def _train_steps(label, step_fn, state: dict, batch, steps: int,
                 want) -> tuple:
    """``steps`` steps of ``step_fn`` on ``batch`` (one batch, so the
    loss each step reports must fall: a few steps over fresh batches of a
    large vocabulary need not show it); every step must launch exactly
    the nonzero counts of ``want`` and no other kernel, and give a finite
    loss and gradient norm.  ``state`` {"params", "opt_state"} is emptied,
    so that the caller holds no reference to the initial state while the
    steps make new ones.  Returns (params, opt_state, losses, norms, wall
    seconds a step)."""
    import numpy as np
    params, opt_state = state.pop("params"), state.pop("opt_state")
    want = {k: v for k, v in want.items() if v}
    losses, norms, times = [], [], []
    for i in range(steps):
        _zero_counts()
        t0 = time.perf_counter()
        params, opt_state, m = step_fn(params, opt_state, batch)
        _sync()
        times.append(time.perf_counter() - t0)
        counts = {k: v for k, v in _read_counts().items() if v}
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        print(f"{label} step {i + 1}: loss={losses[-1]:.6f} "
              f"grad_norm={norms[-1]:.6f} wall_ms={times[-1] * 1e3:.2f} "
              f"kernel_launches={json.dumps(counts)}", flush=True)
        if counts != want:
            raise AssertionError(f"{label} step {i + 1} launches {counts} "
                                 f"!= {want}")
        if not (np.isfinite(losses[-1]) and np.isfinite(norms[-1])):
            raise AssertionError(f"{label}: loss or gradient norm not "
                                 f"finite at step {i + 1}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: the loss did not fall: {losses}")
    return params, opt_state, losses, norms, times


def _train_summary(label, losses, times, tokens) -> None:
    """Median ms a step after the first, steps/s, tokens/s, peak memory,
    the loss."""
    import torch
    ms = statistics.median(times[1:]) * 1e3
    print(f"{label}: {len(times)} steps, median ms/step after the first="
          f"{ms:.2f} (steps: {', '.join(f'{t * 1e3:.1f}' for t in times)}), "
          f"steps/s={1e3 / ms:.3f}, tokens/s={tokens / (ms / 1e3):.1f}, "
          f"peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"(max_memory_allocated), loss {losses[0]:.6f} -> "
          f"{losses[-1]:.6f} [{CARD}]", flush=True)


def _whisper_batch(cfg, B: int) -> dict:
    """A training batch at whisper's published shapes: a 448-token bigram
    batch and frames (B, 1500, 512), drawn from a generator on the card
    seeded SEED + 1, as ``launch/train.py`` draws them."""
    import torch
    from repro_torch.data.synthetic import lm_token_batch
    from repro_torch.launch.train import frontend_inputs
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 1)
    b = lm_token_batch(gen, B, cfg.max_decoder_positions, cfg.vocab_size,
                       device=DEVICE)
    b.update(frontend_inputs(cfg, B, gen, DEVICE))
    return b


def phase_whisper() -> dict:
    """whisper-base at its published width (6 + 6 layers, d 512, 8 x 64
    heads, vocab 51,865), seed-SEED weights. Train: WHISPER_STEPS steps of
    ``make_train_step_fn``, float32 masters and bf16 compute, at batch
    WHISPER_BATCH x (1500 frames, 448 tokens) on one batch (the loss must
    fall), each launching B6f 2L times
    and dq, dk/dv L times (L = 6 decoder layers; the encoder's and the
    cross attention are plain, as in the reference) and nothing else, with
    the plain path's first step on the same state and batch (bf16) and
    the two paths on the trained state in float32.  Prefill:
    ``make_prefill_step_fn`` at batch WHISPER_PREFILL_BATCH, B6 L times,
    kernel against plain logits in bf16 and float32.  Consistency:
    WHISPER_DECODE float32 decode steps with the cross K/V filled from
    ``encode`` -> ``encoder_kv``, against the forward's logits.  Serve:
    the slot engine on WHISPER_SERVE, every request to its end, no kernel
    launched.  Returns the launches of a training step and the prefill,
    and the measured training step for phase 17 (:func:`_measured`)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.specs import (make_loss_for_shape,
                                          make_prefill_step_fn,
                                          make_train_step_fn)
    from repro_torch.models import encdec
    from repro_torch.models.api import build_model
    from repro_torch.serving.engine import DecodeEngine, SlotDecodeEngine
    t_phase = time.perf_counter()
    cfg = get_config("whisper-base")
    api = build_model(cfg)
    L, S, B = cfg.n_layers, cfg.max_decoder_positions, WHISPER_BATCH
    torch.cuda.reset_peak_memory_stats()
    params = api.init(seed=SEED, device=DEVICE, dtype=torch.float32)
    n_params = sum(t.numel() for t in _leaves(params))
    shape = InputShape("whisper_train", S, B, "train")
    step_fn, opt = make_train_step_fn(api, shape, lr=TRAIN_LR)
    plain_step, _ = make_train_step_fn(api, shape, lr=TRAIN_LR,
                                       use_kernel=False)
    state = {"params": params, "opt_state": opt.init(params)}
    batch = _whisper_batch(cfg, B)
    print(f"whisper-base: d_model={cfg.d_model} layers="
          f"{cfg.n_encoder_layers}+{L} heads={cfg.n_heads}x"
          f"{cfg.resolved_head_dim} vocab={cfg.vocab_size} {n_params:,} "
          f"params float32 masters, bf16 compute, batch {B} x "
          f"({cfg.encoder_positions} frames, {S} tokens), adamw(lr="
          f"{TRAIN_LR}, grad_clip_norm=1.0) [{CARD}]", flush=True)

    # the plain path's step from the first kernel step's state and batch
    _zero_counts()
    t0 = time.perf_counter()
    _, _, m = plain_step(params, state["opt_state"], batch)
    _sync()
    plain_ms = (time.perf_counter() - t0) * 1e3
    plain_counts = {k: v for k, v in _read_counts().items() if v}
    loss_p, norm_p = float(m["loss"]), float(m["grad_norm"])
    del m
    if plain_counts:
        raise AssertionError(f"whisper plain step launched {plain_counts}")
    want_step = {fa.B6F: 2 * L, fa.B6_DQ: L, fa.B6_DKV: L}
    del params
    params, opt_state, losses, norms, times = _train_steps(
        "whisper-base train", step_fn, state, batch, WHISPER_STEPS,
        want_step)
    _train_summary("whisper-base train", losses, times, B * S)
    train_step = _measured("13a whisper-base train (median after the "
                           "first)", cfg, shape,
                           statistics.median(times[1:]) * 1e3)
    rel_l = abs(losses[0] - loss_p) / abs(loss_p)
    rel_n = abs(norms[0] - norm_p) / norm_p
    print(f"whisper-base step 1 on the plain path (use_kernel=False): "
          f"loss={loss_p:.6f} grad_norm={norm_p:.6f} wall_ms={plain_ms:.2f}; "
          f"kernel path loss={losses[0]:.6f} grad_norm={norms[0]:.6f}; "
          f"relative differences {rel_l:.3e}, {rel_n:.3e} (limits "
          f"{WHISPER_TRAIN_RTOL['loss']:g}, "
          f"{WHISPER_TRAIN_RTOL['grad_norm']:g})", flush=True)
    if not (rel_l <= WHISPER_TRAIN_RTOL["loss"]
            and rel_n <= WHISPER_TRAIN_RTOL["grad_norm"]):
        raise AssertionError("whisper: the kernel step disagrees with the "
                             "plain one")
    del opt_state
    torch.cuda.empty_cache()
    # the trained state in float32: the kernel path (the FMA flash
    # kernels) against the plain path
    redo, redo_counts = {}, {}
    for label, kw in (("kernel", {"compute_dtype": torch.float32}),
                      ("plain", {"compute_dtype": torch.float32,
                                 "use_kernel": False})):
        _zero_counts()
        redo[label] = _loss_and_grad_norm(
            make_loss_for_shape(api, shape, **kw), params, batch)
        redo_counts[label] = {k: v for k, v in _read_counts().items() if v}
    (lk, nk), (lp, np_) = redo["kernel"], redo["plain"]
    print(f"whisper-base trained state in float32: kernel loss={lk!r} "
          f"grad_norm={nk!r} (launches {json.dumps(redo_counts['kernel'])});"
          f" plain loss={lp!r} grad_norm={np_!r} (launches "
          f"{json.dumps(redo_counts['plain'])}); relative differences "
          f"{abs(lk - lp) / abs(lp):.3e}, {abs(nk - np_) / np_:.3e} (rtol "
          f"{TRAIN_F32_RTOL:g})", flush=True)
    if not (abs(lk - lp) <= TRAIN_F32_RTOL * abs(lp)
            and abs(nk - np_) <= TRAIN_F32_RTOL * np_):
        raise AssertionError("whisper: in float32 the kernel path "
                             "disagrees with the plain one")

    # prefill: B6 once a decoder layer, kernel against plain; the bf16
    # step's last-position logits (rounded to bf16, as the step returns
    # them) and the float32 forward's (not rounded)
    Bp = WHISPER_PREFILL_BATCH
    pshape = InputShape("whisper_prefill", S, Bp, "prefill")
    pb = {k: v[:Bp] for k, v in batch.items() if k != "labels"}
    runs, prefill_counts = {}, {}
    with torch.no_grad():
        for label, kw in (("kernel", {}), ("plain", {"use_kernel": False})):
            for dt in ("bfloat16", "float32"):
                step = make_prefill_step_fn(api, pshape, **kw)
                if dt == "float32":
                    def step(p, b, kw=kw):
                        return api.forward(
                            p, b["tokens"], frames=b["frames"],
                            compute_dtype=torch.float32, remat=False,
                            **kw)[0][:, -1]
                _zero_counts()
                t0 = time.perf_counter()
                out = step(params, pb)
                _sync()
                ms = (time.perf_counter() - t0) * 1e3
                counts = {k: v for k, v in _read_counts().items() if v}
                runs[label, dt] = out
                print(f"whisper-base prefill [{label}, {dt}]: batch {Bp} x "
                      f"({cfg.encoder_positions} frames, {S} tokens), "
                      f"logits {tuple(out.shape)} wall_ms={ms:.2f} "
                      f"kernel_launches={json.dumps(counts)}", flush=True)
                if label == "kernel" and dt == "bfloat16":
                    prefill_counts = counts
                    if counts != {fa.B6: L}:
                        raise AssertionError(f"whisper prefill launches "
                                             f"{counts} != B6 x {L}")
                if label == "plain" and counts:
                    raise AssertionError(f"whisper plain prefill launched "
                                         f"{counts}")
                if not bool(torch.isfinite(out).all()):
                    raise AssertionError(f"whisper {label} {dt} prefill "
                                         "logits not finite")
    for dt in ("bfloat16", "float32"):
        rel, mx = _logits_gap(runs["kernel", dt], runs["plain", dt])
        print(f"whisper-base prefill kernel vs plain [{dt}]: rel_l2="
              f"{rel:.3e} max_abs={mx:.3e} (limit "
              f"{WHISPER_PREFILL_REL_L2[dt]:g})", flush=True)
        if not rel <= WHISPER_PREFILL_REL_L2[dt]:
            raise AssertionError(f"whisper {dt} prefill: the kernel "
                                 "disagrees with the plain path")
    del runs

    # consistency: float32 decode with the cross K/V from the encoder,
    # against the forward's logits
    Bd, Sd = 2, WHISPER_DECODE
    frames = batch["frames"][:Bd]
    tokens = batch["tokens"][:Bd, :Sd]
    with torch.no_grad():
        fwd, _ = api.forward(params, tokens, frames=frames,
                             compute_dtype=torch.float32, remat=False)
        cache = api.init_cache(Bd, Sd, dtype=torch.float32, device=DEVICE)
        enc = encdec.encode(params, frames, cfg, compute_dtype=torch.float32)
        cache["cross"] = encdec.encoder_kv(params, enc, cfg)
        outs = []
        t0 = time.perf_counter()
        for t in range(Sd):
            logits, cache = api.decode_step(params, cache,
                                            tokens[:, t:t + 1],
                                            compute_dtype=torch.float32)
            outs.append(logits[:, 0])
        _sync()
        dec_ms = (time.perf_counter() - t0) * 1e3 / Sd
    dec = torch.stack(outs, 1)
    rel, mx = _logits_gap(dec, fwd)
    agree = float((dec.argmax(-1) == fwd.argmax(-1)).float().mean())
    print(f"whisper-base decode vs forward [float32, cross K/V from the "
          f"encoder]: {Bd} x {Sd} tokens, rel_l2={rel:.3e} max_abs="
          f"{mx:.3e} (limit {WHISPER_DECODE_REL_L2:g}), same argmax "
          f"{agree:.4f}, {dec_ms:.2f} ms a decode step", flush=True)
    if not rel <= WHISPER_DECODE_REL_L2:
        raise AssertionError("whisper: decode disagrees with the forward")
    del params, fwd, dec, outs, cache, enc, batch
    torch.cuda.empty_cache()

    # serving: the slot engine on bf16 weights
    n_req, n_new, slots = WHISPER_SERVE
    sparams = api.init(seed=SEED, device=DEVICE, dtype=torch.bfloat16)
    eng = DecodeEngine(api, sparams, n_slots=slots, cache_len=64,
                       device=DEVICE)
    if not isinstance(eng, SlotDecodeEngine):
        raise AssertionError("whisper is not served by the slot engine")
    rng = np.random.default_rng(SEED)
    for _ in range(n_req):
        eng.submit(rng.integers(0, cfg.vocab_size, 8).astype(np.int32),
                   n_new)
    _zero_counts()
    t0 = time.perf_counter()
    finished = eng.run_until_drained()
    _sync()
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in _read_counts().items() if v}
    print(f"whisper-base serve: SlotDecodeEngine slots={slots} requests="
          f"{len(finished)}/{n_req} steps={eng.steps} tokens="
          f"{eng.tokens_decoded} wall_s={wall:.3f} tok_per_s="
          f"{eng.tokens_decoded / wall:.2f} ms_per_step="
          f"{wall / eng.steps * 1e3:.2f} kernel_launches="
          f"{json.dumps(counts)} [{CARD}]", flush=True)
    if len(finished) != n_req or counts or not all(
            len(r.generated) == n_new for r in finished):
        raise AssertionError("whisper serve: a request did not finish, or "
                             "a kernel launched")
    del eng, sparams
    torch.cuda.empty_cache()
    print(f"phase 13a: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"train": {k: v for k, v in want_step.items() if v},
            "prefill": prefill_counts, "step": train_step}


def phase_recurrent_train(arch: str) -> dict:
    """``arch`` at its published width, depth cut by ``_depth_cut``,
    float32 masters and bf16 compute, trained RECURRENT_TRAIN[arch]'s
    steps on one batch of 1: the loss must fall, the gradient norm stay
    finite,
    and every step launch B6f twice and dq, dk/dv once per
    shared-attention application (zamba2; xLSTM has no attention) and no
    B5 or B4: the loss runs the scans' plain chunkwise forms.  Returns a
    step's launches."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.data.synthetic import lm_token_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.specs import make_train_step_fn
    from repro_torch.models.api import build_model
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    L, text, n_want = _depth_cut(arch)
    print(text, flush=True)
    seq, steps = RECURRENT_TRAIN[arch]
    cfg = dataclasses.replace(get_config(arch), n_layers=L)
    api = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init(seed=SEED, device=DEVICE, dtype=torch.float32)
    _sync()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"{arch} train: {L} layers, {n_params:,} params float32 masters "
          f"(reckoned {n_want:,.0f}) in {time.perf_counter() - t0:.1f} s, "
          f"bf16 compute, batch 1 x {seq}, adamw(lr={TRAIN_LR}, "
          f"grad_clip_norm=1.0), remat per segment [{CARD}]", flush=True)
    if n_params != round(n_want):
        raise AssertionError(f"{arch}: the reckoned parameter count is off")
    shape = InputShape(f"train_{seq}", seq, 1, "train")
    step_fn, opt = make_train_step_fn(api, shape, lr=TRAIN_LR)
    state = {"params": params, "opt_state": opt.init(params)}
    del params
    gen = torch.Generator()
    gen.manual_seed(SEED + 1)
    batch = lm_token_batch(gen, 1, seq, cfg.vocab_size, device=DEVICE)
    n_attn = L // cfg.hybrid_attn_every if cfg.hybrid_attn_every else 0
    want = {fa.B6F: 2 * n_attn, fa.B6_DQ: n_attn, fa.B6_DKV: n_attn}
    params, opt_state, losses, norms, times = _train_steps(
        f"{arch} train", step_fn, state, batch, steps, want)
    _train_summary(f"{arch} train ({L} layers)", losses, times, seq)
    del params, opt_state, batch
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 13{'b' if n_attn else 'c'}: "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return {k: v for k, v in want.items() if v}


KERNELS = [("paged_attention_tiled", "paged_attention_tiled_tc",
            "paged_attention.py:373"),
           ("paged_attention_ragged", "paged_attention_ragged_tc",
            "paged_attention.py:242"),
           ("paged_attention_rows", "paged_attention_rows_tc",
            "paged_attention.py:109"),
           ("pseudo_voigt", "pseudo_voigt", "pseudo_voigt.py:81"),
           ("flash_attention", "flash_attention_fwd_wgmma",
            "flash_attention.py:96"),
           ("flash_attention_lse", "flash_attention_fwd_wgmma",
            "flash_attention.py:266"),
           ("flash_attention_dq", "flash_attention_bwd_wgmma",
            "flash_attention.py:316"),
           ("flash_attention_dkv", "flash_attention_bwd_wgmma",
            "flash_attention.py:337"),
           ("ssd_scan", "ssm_scan_tc", "ssm_scan.py:74"),
           ("mlstm_scan", "mlstm_scan_tc", "mlstm_scan.py:89")]


# ---------------------------------------------------------------------------
# phase 14: mesh serving
# ---------------------------------------------------------------------------
MESH_TPS = (2, 4)             # 14a: tensor-parallel degrees
MESH_F32_LAYERS = 4           # 14d-e: float32 at full width, depth cut
# 14b-c: the first prefill step's logits, bf16, TP 2 against tp 1 in the
# same layout, as a relative 2-norm.  The two paths sum each layer's
# partial products in another order and round the sums to bf16 at other
# points, compounded over 28 layers; the limit is about 4x the first card
# reading, 2.472e-2 in the default layout (PERF.md).  The other layouts
# change only the attention read, which runs the same on both sides, and
# int8 pools quantize per kv head, so the shards store the same bytes:
# they are held to the same limit
MESH_BF16_REL_L2 = 0.1


def _positions(tp: int, dp: int = 1, cards: bool = False):
    """A ("data", "model") mesh of dp x tp positions that all name the
    one card, or with ``cards`` position i on card i."""
    import torch
    from repro_torch.launch.mesh import Mesh
    n = dp * tp
    devices = ([torch.device(DEVICE, i) for i in range(n)] if cards
               else [torch.device(DEVICE, 0)] * n)
    return Mesh(devices, ("data", "model"), shape=(dp, tp))


def _where(mesh) -> str:
    """The positions' cards, as the phases' lines print them."""
    devices = [str(d) for d in mesh.devices.reshape(-1)]
    if len(set(devices)) == 1:
        return f"all {devices[0]} (they share the card)"
    return f"on {', '.join(devices)}"


TWO_CARDS_SKIP = ("not run: torch.cuda.device_count() is {n}, and this "
                  "run needs a second card")


def _mesh_gib(api, params, tp: int, slices: int = 1,
              pool_dtype=None) -> tuple:
    """(GiB of parameter shards the engines copy, GiB of their pools),
    reckoned before building them: a leaf cut along a dim with larger
    dims before it is copied once over its tp shards (a cut along its
    leading dim is a view, a replicated leaf shared), and every slice
    holds the fleet's 8 x 512-token pools split over its positions."""
    import math
    import torch
    from repro_torch.launch import sharding as sh
    cfg = api.cfg
    copied = 0
    if tp > 1:
        specs = api.tp_plan(sh.serving_param_specs(params, {"model": tp}),
                            [torch.device(DEVICE, 0)] * tp).specs
        for leaf, spec in zip(sh.leaves(params), sh.leaves(specs)):
            dims = [d for d, c in enumerate(spec) if c is not None]
            if dims and math.prod(leaf.shape[:dims[0]]) > 1:
                copied += leaf.numel() * leaf.element_size()
    dtype = pool_dtype or params["embed"]["embedding"].dtype
    blocks = 8 * (512 // 16) + 1
    elems = cfg.n_layers * blocks * 16 * cfg.n_kv_heads
    pool = 2 * elems * cfg.resolved_head_dim * dtype.itemsize
    if dtype == torch.int8:
        pool += 2 * elems * 4
    return slices * copied / 2**30, slices * pool / 2**30


def _mesh_fleet(api, params, label, *, kernel=None, tp=1, dp=1,
                cards=False, **engine_kw) -> tuple:
    """Phase 4's fleet through a paged engine on ``tp`` positions of the
    card (with ``cards``, position i on card i), or (dp > 1) a
    ShardedDecodeEngine of dp slices of tp; counts
    zeroed just before and read just after.  Every request must finish
    with its tokens, and the path must launch ``kernel`` layers x tp x
    steps (the slices' steps summed) and no other paged read.  A single
    engine must run its prefix cache, CoW and speculation, and count the
    step design's collectives, 2 L + 2 where tp > 1; a front's per-slice
    lists must sum to its totals.  Returns (engine, tokens by request,
    wall s)."""
    import torch
    from repro_torch.launch.profile_serve import serve_fleet
    from repro_torch.serving.engine import ShardedDecodeEngine
    cfg = api.cfg
    L = cfg.n_layers
    copied, pool = _mesh_gib(api, params, tp, dp,
                             engine_kw.get("cache_dtype"))
    mesh_kw = {}
    mesh = _positions(tp, dp, cards)
    if dp > 1:
        mesh_kw = dict(engine_cls=ShardedDecodeEngine, mesh=mesh)
    elif tp > 1:
        mesh_kw = dict(mesh=mesh)
    before = torch.cuda.memory_allocated() / 2**30
    _tag(f"mesh [{label}]: {dp} x {tp} positions, {_where(mesh)}; "
         f"reckoned {copied:.2f} GiB of shard copies + {pool:.2f} GiB of "
         f"pools over the {before:.2f} GiB held")
    _zero_counts()
    eng, finished, wall = serve_fleet(api, params, max_new=DIS_NEW,
                                      seed=SEED, device=DEVICE, **mesh_kw,
                                      **engine_kw)
    counts = _nonzero(_read_counts())
    s = eng.stats()
    got = {r.request_id: list(r.generated) for r in finished}
    _tag(f"mesh [{label}]: {cfg.name} layers={L} requests={len(finished)} "
         f"steps={eng.steps} tokens={eng.tokens_decoded} "
         f"wall_s={wall:.6f} ms_per_step={wall / eng.steps * 1e3:.3f} "
         f"tok_per_s={eng.tokens_decoded / wall:.2f} "
         f"collectives_per_step={s['collectives_per_step']} "
         f"(design {2 * L + 2 if tp > 1 else 0}) "
         f"collective_ops={s['collective_ops']} "
         f"kv_heads_sharded={s.get('kv_heads_sharded')} "
         f"allocated_gib={torch.cuda.memory_allocated() / 2**30:.2f} "
         f"kernel_launches={json.dumps(counts)}")
    if len(finished) != 8 or any(len(t) != DIS_NEW for t in got.values()):
        raise AssertionError(f"[{label}] not every request finished with "
                             "its tokens")
    steps = (sum(p["steps"] for p in s["per_slice"]) if dp > 1
             else eng.steps)
    want = {kernel: L * tp * steps}
    if counts != want:
        raise AssertionError(f"[{label}] kernel launches {counts} != {want} "
                             "(layers x tp x steps on its own kernel)")
    if dp > 1:
        per = s["tokens_decoded_per_slice"]
        _tag(f"mesh [{label}]: per slice tokens={per} prefilled="
             f"{s['tokens_prefilled_per_slice']} collective_ops="
             f"{s['collective_ops_per_slice']} steps="
             f"{[p['steps'] for p in s['per_slice']]}")
        if not (sum(per) == s["tokens_decoded"]
                and sum(s["tokens_prefilled_per_slice"])
                == s["tokens_prefilled"]
                and sum(s["collective_ops_per_slice"])
                == s["collective_ops"] and all(t > 0 for t in per)):
            raise AssertionError(f"[{label}] per-slice lists do not sum to "
                                 "the totals or a slice did not decode")
        return eng, got, wall
    if not (s["prefix_hits"] > 0 and s["cow_copies"] > 0
            and s["spec_verifications"] > 0):
        raise AssertionError(f"[{label}] prefix cache, CoW or speculation "
                             "did not run")
    if s["collectives_per_step"] != (2 * L + 2 if tp > 1 else 0):
        raise AssertionError(f"[{label}] {s['collectives_per_step']} "
                             "collectives a step, not the design's")
    return eng, got, wall


def _first_step_logits(api, params, **engine_kw):
    """The real rows of the logits of the fleet's first engine step (8
    prompts' first prefill chunks), float32."""
    import torch
    from repro_torch.launch.profile_serve import shared_prefix_fleet
    from repro_torch.serving.engine import PagedDecodeEngine
    eng = PagedDecodeEngine(api, params, n_slots=8, cache_len=512,
                            window=api.effective_window(512), device=DEVICE,
                            **engine_kw)
    first, others = shared_prefix_fleet(api.cfg.vocab_size, SEED)
    for p in [first] + others:
        eng.submit(p, DIS_NEW)
    got = []
    run = eng._run_step
    eng._run_step = lambda tokens: got.append(run(tokens)) or got[-1]
    eng.step()
    logits = got[0]
    if logits.dim() == 3:        # the rectangular step: each lane's rows
        logits = torch.cat([logits[b, :n] for b, n
                            in enumerate(eng.cache["q_lens"].tolist())])
    return logits[:eng.scheduled_tokens].float()


def phase_mesh() -> None:
    """14: gemma-7b served by the tensor-parallel paged engine and the
    data-parallel front on positions that share the card."""
    import gc
    import torch
    t0 = time.perf_counter()
    api, params = _init_full("gemma-7b")
    tiled, ragged, rows = ("paged_attention_tiled", "paged_attention_ragged",
                           "paged_attention_rows")
    # (a) tp 1, then TP 2 and TP 4 in the default layout
    eng, base, base_wall = _mesh_fleet(api, params, "tp 1", kernel=tiled)
    del eng
    for tp in MESH_TPS:
        eng, got, wall = _mesh_fleet(api, params, f"TP {tp}", kernel=tiled,
                                     tp=tp)
        agree1, agree = _agreement(got, base)
        _tag(f"mesh [TP {tp}]: bf16 greedy agreement with tp 1: first "
             f"tokens {agree1:.4f}, all tokens {agree:.4f}; wall "
             f"{wall / base_wall:.3f} x tp 1's")
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    # (a) on two cards where there are two: the launches as on one card
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        eng, got, wall = _mesh_fleet(api, params, "TP 2 on 2 cards",
                                     kernel=tiled, tp=2, cards=True)
        agree1, agree = _agreement(got, base)
        _tag(f"mesh [TP 2 on 2 cards]: bf16 greedy agreement with tp 1: "
             f"first tokens {agree1:.4f}, all tokens {agree:.4f}; wall "
             f"{wall / base_wall:.3f} x tp 1's")
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    else:
        _tag("mesh [TP 2 on 2 cards]: " + TWO_CARDS_SKIP.format(n=n_cards))
    # (b) TP 2 in the per-token and rectangular layouts and with int8
    # pools, then (c) in every layout the first prefill step's logits
    # against tp 1's in the same layout
    for label, kw, kernel in (("TP 2", {}, None),
                              ("TP 2 tiled=False", {"tiled": False}, ragged),
                              ("TP 2 ragged=False", {"ragged": False}, rows),
                              ("TP 2 int8 pools",
                               {"cache_dtype": torch.int8}, tiled)):
        if kernel is not None:      # the default layout's fleet ran in (a)
            eng, _, _ = _mesh_fleet(api, params, label, kernel=kernel, tp=2,
                                    **kw)
            del eng
            gc.collect()
            torch.cuda.empty_cache()
        want = _first_step_logits(api, params, **kw)
        gc.collect()
        got = _first_step_logits(api, params, mesh=_positions(2), **kw)
        rel, err = _logits_gap(got, want)
        same = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
        _tag(f"mesh [logits {label}]: first step ({got.shape[0]} rows) bf16 "
             f"vs tp 1 rel_l2={rel:.4e} (limit {MESH_BF16_REL_L2}) max_err="
             f"{err:.4e} max|logit|={want.abs().max().item():.3f} argmax "
             f"agreement={same:.4f}")
        if not rel <= MESH_BF16_REL_L2:
            raise AssertionError(f"[{label}] logits rel_l2 {rel} > "
                                 f"{MESH_BF16_REL_L2}")
        del got, want
        gc.collect()
        torch.cuda.empty_cache()
    # (e) the data-parallel front on (2, 1) and (2, 2) meshes, bf16
    for tp in (1, 2):
        eng, _, _ = _mesh_fleet(api, params, f"DP 2 x TP {tp}",
                                kernel=tiled, tp=tp, dp=2)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    del params
    # (d, e) float32 at MESH_F32_LAYERS layers: every token tp 1's
    api, params = _init_full("gemma-7b", "float32",
                             n_layers=MESH_F32_LAYERS)
    eng, base, _ = _mesh_fleet(api, params, "f32 tp 1", kernel=tiled)
    del eng
    for label, kw in ([(f"f32 TP {tp}", {"kernel": tiled, "tp": tp})
                       for tp in MESH_TPS]
                      + [(f"f32 DP 2 x TP {tp}",
                          {"kernel": tiled, "tp": tp, "dp": 2})
                         for tp in (1, 2)]
                      + ([("f32 TP 2 on 2 cards",
                           {"kernel": tiled, "tp": 2, "cards": True})]
                         if n_cards >= 2 else [])):
        eng, got, _ = _mesh_fleet(api, params, label, **kw)
        _tag(f"mesh [{label}]: tokens equal tp 1's: {got == base}")
        if got != base:
            raise AssertionError(f"[{label}] float32 tokens differ from "
                                 "the tp 1 engine's")
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    _tag(f"phase 14: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 15: sharded training
# ---------------------------------------------------------------------------
# (label, arch, layers, (dp, tp), batch, seq, bf16 steps, pre_gather,
# policy)
SHARD_RUNS = [("15a gemma-7b TP 2", "gemma-7b", TRAIN_LAYERS, (1, 2), 1,
               4096, 5, False, "baseline"),
              ("15b gemma-7b DP 2 x TP 2", "gemma-7b", TRAIN_LAYERS, (2, 2),
               2, 2048, 3, True, "baseline"),
              ("15c deepseek-moe-16b TP 2", "deepseek-moe-16b", 3, (1, 2),
               1, 2048, 3, False, "baseline")]
# phase 16: the other families.  (a) tensor-parallel at phase 8b's depth
# cut, its 1216 tokens after the 2880 patch embeddings; (b)-(d) gathered
# (the whole tree on every position, the rows cut over all of them):
# whisper-base whole at phase 13a's batch, zamba2-2.7b at 2 of 9
# segments, xlstm-1.3b at 1 of 6 under fsdp_flat with pre_gather
FAMILY_RUNS = [("16a llava-next-mistral-7b TP 2", "llava-next-mistral-7b",
                TRAIN_LAYERS, (1, 2), 1, 1216, 3, False, "baseline"),
               ("16b whisper-base DP 2 x TP 2 gathered", "whisper-base", 6,
                (2, 2), 8, 448, 3, False, "baseline"),
               ("16c zamba2-2.7b (1, 2) gathered", "zamba2-2.7b", 12, (1, 2),
                2, 2048, 3, False, "baseline"),
               ("16d xlstm-1.3b (2, 2) fsdp_flat", "xlstm-1.3b", 8, (2, 2), 4,
                256, 3, True, "fsdp_flat")]
# the first bf16 step from the seed state, the sharded step against the
# one position's: the partial products summed in another order and
# rounded to bf16 at other points, over a few layers, averaged over the
# batch's tokens in the loss; written before the first card run (PERF.md)
SHARD_BF16_LOSS_RTOL = 5e-3
SHARD_BF16_NORM_RTOL = 5e-2
# one float32 step from the seed state, the sharded step against the one
# position's: loss, gradient norm and the MoE aux as relative
# differences, each leaf's post-AdamW parameters and AdamW first moment
# as relative 2-norms; the order of sums only (written before the first
# card run, PERF.md)
SHARD_F32_RTOL = 1e-5
# AdamW's first step moves an element by lr * g / (|g| + eps): a sign for
# |g| >> eps, but where the (clipped) gradient lies within
# SHARD_EPS_SPAN * eps of zero it turns the gradient's rounding into a
# visible move.  Such elements (a zero-initialised bias fed by cancelling
# sums: llava's projector/b1 behind the patches, which carry no loss) are
# held within 2 lr, AdamW's largest first step, of the one position's;
# every other element by its leaf's relative 2-norm
SHARD_EPS_SPAN = 100


def _shard_design(plan) -> int:
    """A sharded train step's collectives on one data slice by the step
    design: the forward's (the embedding's reduce, the logits' gather,
    one reduce per cut sublayer, a gather of cut router logits and the
    VLM's projector reduce), one backward dual each, and the layers'
    forward ones again in the remat recomputation."""
    from repro_torch.models import vlm
    fwd = int(plan.embed) + int(plan.head)
    if plan.specs is not None and "projector" in plan.specs:
        fwd += int(vlm._projector_cut(plan))
    layers = 0
    for lp in plan.layers:
        ffn = [v for k, v in lp.items() if k not in ("attn", "router")]
        layers += int(lp["attn"]) + int(any(ffn)) + int(lp.get("router",
                                                              False))
    return 2 * (fwd + layers) + layers


def _attention_layers(cfg) -> int:
    """Causal attention applications of a training forward: every layer
    of the transformer families and whisper's decoder, zamba2's shared
    block once a segment, none in xLSTM."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid_attn_every
    return cfg.n_layers


def _rel2(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()
            .clamp_min(1e-30)).item()


def _shard_f32_check(label, api, shape, mesh, specs, placed, batch, base,
                     routes) -> None:
    """One float32 step of the sharded path from ``placed`` against the
    one position's ``base`` (loss, grad norm, aux, and the new parameters'
    and first moments' leaves on the host), within SHARD_F32_RTOL."""
    import torch
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.specs import make_train_step_fn
    from repro_torch.optim.optimizers import tree_leaves
    step, opt = make_train_step_fn(api, shape, lr=TRAIN_LR, mesh=mesh,
                                   specs=specs,
                                   compute_dtype=torch.float32)
    tp = mesh.shape["model"]
    if routes is not None:
        routes.start(use_kernel=False, per=tp)
    _zero_counts()
    t0 = time.perf_counter()
    new_p, new_s, m = step(placed, opt.init(placed), batch)
    _sync()
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in _read_counts().items() if v}
    if routes is not None:
        E = routes.mo.n_experts
        sets = lambda idx: torch.nn.functional.one_hot(idx, E).sum(-2) > 0
        differ = sum(int((sets(own) != sets(routes.kernel[i // tp]))
                         .any(-1).sum()) for i, own in enumerate(routes.own))
        _tag(f"{label} float32: the one position's routes replayed; "
             f"(token, routing call) whose own top-k set differs from them "
             f"{differ} over {len(routes.own)} calls")
    gaps = {k: abs(float(m[k]) - base[k]) / abs(base[k])
            for k in base if k in ("loss", "grad_norm", "moe_aux")}
    worst, where = {}, {}
    paths = []
    sh._map_with_path(lambda path, _: paths.append(path), specs)
    # the one position's clipped gradient is its first moment / (1 - b1)
    near = [(b / 0.1).abs() < SHARD_EPS_SPAN * 1e-8 for b in base["m"]]
    step_lr = []
    for name, tree in (("params", new_p), ("m", new_s["m"])):
        whole = tree_leaves(sh.unshard(tree, specs, mesh))
        gaps_l = []
        for a, b, nz in zip(whole, base[name], near):
            b, nz = b.to(a.device), nz.to(a.device)
            if name == "m":
                gaps_l.append(_rel2(a, b))
                continue
            gaps_l.append(_rel2(a[~nz], b[~nz]) if (~nz).any() else 0.0)
            if nz.any():
                step_lr.append((a - b)[nz].abs().max().item() / TRAIN_LR)
        worst[name] = max(gaps_l)
        where[name] = paths[gaps_l.index(worst[name])]
        del whole
    n_near = sum(int(nz.sum()) for nz in near)
    _tag(f"{label} float32 step vs one position: wall_ms={wall * 1e3:.2f} "
         + " ".join(f"{k}={float(m[k]):.6f} (rel {g:.3e})"
                    for k, g in gaps.items())
         + f"; max leaf rel_l2 params {worst['params']:.3e} "
         f"({where['params']}), first moment {worst['m']:.3e} "
         f"({where['m']}) (limit {SHARD_F32_RTOL:g}); {n_near} elements "
         f"within {SHARD_EPS_SPAN} eps of a zero gradient moved {max(step_lr, default=0.0):.3f} lr at most from "
         f"the one position's (limit 2); kernel_launches="
         f"{json.dumps(counts)}")
    if not (max(gaps.values()) <= SHARD_F32_RTOL
            and max(worst.values()) <= SHARD_F32_RTOL
            and max(step_lr, default=0.0) <= 2):
        raise AssertionError(f"{label}: the float32 sharded step disagrees "
                             "with the one position's")
    del new_p, new_s, m


def _shard_run(label, arch, layers, dp_tp, batch_size, seq, steps,
               pre_gather, policy, cards=False) -> dict:
    """One phase-15 or phase-16 run (see the module docstring), on
    positions that share the card or, with ``cards``, one card each.
    Returns the launches of its bf16 steps by kernel."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.data.synthetic import lm_token_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.specs import (_bf16, gathers_whole,
                                          make_loss_for_shape,
                                          make_train_step_fn, train_specs)
    from repro_torch.launch.train import frontend_inputs
    from repro_torch.models.api import build_model
    from repro_torch.optim.optimizers import tree_leaves
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, impl="gshard"))
    api = build_model(cfg)
    dp, tp = dp_tp
    P = dp * tp
    mesh = _positions(tp, dp, cards)
    extra = cfg.frontend.n_tokens if cfg.family == "vlm" else 0
    shape = InputShape("phase15", extra + seq, batch_size, "train")
    params = api.init(seed=SEED, device=DEVICE, dtype=torch.float32)
    gen = torch.Generator()
    gen.manual_seed(SEED + 1)
    batch = lm_token_batch(gen, batch_size, seq, cfg.vocab_size,
                           device=DEVICE)
    batch.update(frontend_inputs(cfg, batch_size, gen, DEVICE))
    n = sum(t.numel() for t in _leaves(params))
    inputs = "".join(f" + {k} {tuple(v.shape[1:])}" for k, v in batch.items()
                     if k not in ("tokens", "labels"))
    _tag(f"{label}: {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads}x"
         f"{cfg.resolved_head_dim} layers={layers} of "
         f"{get_config(arch).n_layers}"
         + (f" (experts {cfg.moe.n_experts}, {cfg.moe.n_experts // tp} a "
            f"position)" if cfg.moe else "")
         + f", {n / 1e9:.3f} B params float32, {dp} x {tp} positions "
         f"{_where(mesh)}, batch {batch_size} x {seq} tokens{inputs}, "
         f"policy {policy}, pre_gather={pre_gather}, "
         f"adamw(lr={TRAIN_LR}, grad_clip_norm=1.0)")
    routes = _RoutePin(cfg.moe) if cfg.moe else None

    # the one position from the seed state: the bf16 step's loss and
    # gradient norm, then a float32 step whose results go to the host
    loss = make_loss_for_shape(api, shape)
    base16 = _loss_and_grad_norm(
        (lambda p, b: loss(_bf16(p), b)) if pre_gather else loss, params,
        batch)
    torch.cuda.empty_cache()
    one_step, one_opt = make_train_step_fn(api, shape, lr=TRAIN_LR,
                                           compute_dtype=torch.float32)
    if routes is not None:
        routes.__enter__()
        routes.start(use_kernel=True)
    specs = train_specs(api, params, mesh, policy)
    base = _one_position_f32(one_step(params, one_opt.init(params), batch))
    if gathers_whole(api, specs):
        # the gathered step sums its rows' shares; the one position on
        # the same shares is its float32 reference, and the order of
        # sums over the rows alone is printed
        shares = _one_position_f32(_shares_step(api, shape, P)(
            params, one_opt.init(params), batch))
        paths = []
        sh._map_with_path(lambda path, _: paths.append(path), specs)
        gaps = [_rel2(a, b) for a, b in zip(shares["m"], base["m"])]
        rel = {k: abs(shares[k] - base[k]) / base[k]
               for k in ("loss", "grad_norm")}
        _tag(f"{label} float32, one position, the rows batched vs summed "
             f"in {P} shares: loss rel {rel['loss']:.3e}, grad_norm rel "
             f"{rel['grad_norm']:.3e}, "
             f"max leaf rel_l2 first moment {max(gaps):.3e} "
             f"({paths[gaps.index(max(gaps))]}): the order of sums over "
             "the rows")
        base = shares

    try:
        placed = sh.place(params, specs, mesh)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        _shard_f32_check(label, api, shape, mesh, specs, placed, batch,
                         base, routes)
    finally:
        if routes is not None:
            routes.__exit__()
    del base
    gc.collect()
    torch.cuda.empty_cache()

    step, opt = make_train_step_fn(api, shape, lr=TRAIN_LR, mesh=mesh,
                                   specs=specs, pre_gather=pre_gather)
    gathered = gathers_whole(api, specs)
    plans = [] if gathered else step.plans
    design = [_shard_design(p) for p in plans]
    seen = []

    def counted(p, s, b):
        for plan in plans:
            plan.reset()
        out = step(p, s, b)
        seen.append([plan.collectives for plan in plans])
        if seen[-1] != design:
            raise AssertionError(f"{label}: collectives {seen[-1]} a slice "
                                 f"!= the design's {design}")
        return out

    A = _attention_layers(cfg)
    want = {fa.B6: 0, fa.B6F: 2 * A * P, fa.B6_DQ: A * P, fa.B6_DKV: A * P}
    state = {"params": placed, "opt_state": opt.init(placed)}
    del placed
    _tag(f"{label}: peak memory of the float32 steps "
         f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
         f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB held before the "
         "bf16 steps")
    torch.cuda.reset_peak_memory_stats()
    _, _, losses, norms, times = _train_steps(f"{label} bf16", counted,
                                              state, batch, steps, want)
    rel_l = abs(losses[0] - base16[0]) / abs(base16[0])
    rel_n = abs(norms[0] - base16[1]) / base16[1]
    regime = (f"gathered on {len(step.gather.devices)} positions, "
              f"{step.gather.gathers} leaves gathered, collectives a step "
              f"{step.gather.collectives} (gathers and their duals)"
              if gathered else f"collectives a step a slice {seen[0]} "
              f"(design {design})")
    _tag(f"{label}: first bf16 step vs one position from the same state "
         f"and batch: loss {losses[0]:.6f} vs {base16[0]:.6f} (rel "
         f"{rel_l:.3e}, limit {SHARD_BF16_LOSS_RTOL:g}), grad_norm "
         f"{norms[0]:.6f} vs {base16[1]:.6f} (rel {rel_n:.3e}, limit "
         f"{SHARD_BF16_NORM_RTOL:g}); {regime}; launches a step "
         f"{json.dumps({k: v for k, v in want.items() if v})} "
         f"({P} positions)")
    _train_summary(f"{label} bf16", losses, times,
                   batch_size * (extra + seq))
    if not (rel_l <= SHARD_BF16_LOSS_RTOL and rel_n <= SHARD_BF16_NORM_RTOL):
        raise AssertionError(f"{label}: the first bf16 sharded step "
                             "disagrees with the one position's")
    gc.collect()
    torch.cuda.empty_cache()
    _tag(f"phase {label.split()[0]}: {time.perf_counter() - t0:.1f} s")
    return {k: v * steps for k, v in want.items()}


def _one_position_f32(out) -> dict:
    """A one-position float32 step's metrics, and its new parameters' and
    first moments' leaves on the host."""
    import torch
    from repro_torch.optim.optimizers import tree_leaves
    new_p, new_s, m = out
    base = {k: float(v) for k, v in m.items()}
    base["params"] = [t.cpu() for t in tree_leaves(new_p)]
    base["m"] = [t.cpu() for t in tree_leaves(new_s["m"])]
    del new_p, new_s, m, out
    torch.cuda.empty_cache()
    return base


def _shares_step(api, shape, n: int):
    """The one-position float32 step whose loss sums the batch's rows in
    ``n`` shares (``loss_parts`` each, added before dividing), as the
    gathered regime sums its positions' rows."""
    import torch
    from repro_torch.launch import specs as specs_lib
    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import make_train_step
    kw = specs_lib._loss_kwargs(api, shape, compute_dtype=torch.float32)

    def loss(p, b):
        dev = b["tokens"].device
        return transformer.parts_loss(
            [api.loss_parts(p, rows, **kw)
             for rows in specs_lib._rows(b, [dev] * n)], api.cfg, dev)

    return make_train_step(loss, adamw(TRAIN_LR, grad_clip_norm=1.0))


def _runs(runs) -> dict:
    """``_shard_run`` of each of ``runs``; the launches of their bf16
    steps by kernel, summed."""
    totals = {}
    for run in runs:
        for k, v in _shard_run(*run).items():
            totals[k] = totals.get(k, 0) + v
    return totals


def phase_sharded_training() -> dict:
    """15a-c; returns the launches of their bf16 steps by kernel."""
    return _runs(SHARD_RUNS)


def phase_sharded_families() -> dict:
    """16a-d, then 16a again on two cards where there are two; returns
    the launches of the one-card runs' bf16 steps by kernel."""
    import torch
    t0 = time.perf_counter()
    totals = _runs(FAMILY_RUNS)
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        _shard_run(FAMILY_RUNS[0][0] + " on 2 cards", *FAMILY_RUNS[0][1:],
                   cards=True)
    else:
        _tag(f"{FAMILY_RUNS[0][0]} on 2 cards: "
             + TWO_CARDS_SKIP.format(n=n_cards))
    _tag(f"phase 16: {time.perf_counter() - t0:.1f} s")
    return totals


# ---------------------------------------------------------------------------
# phase 17: the measured steps against their roofline bound
# ---------------------------------------------------------------------------
# the largest share of its bound a measured step may read: the bound is
# the least time the card could take, so a share above 1 means that the
# account or the timed window is wrong (5 % for the timers' spread)
ROOFLINE_SHARE_MAX = 1.05
FULL_PREFILL = 4096           # 17a: gemma-7b prefill at 1 x this
FULL_DECODE = (8, 4096)       # 17a: gemma-7b decode, batch x cache slots


def _measured(label: str, cfg, shape, ms: float) -> dict:
    """A measured step for phase 17: its config (depth cut where the phase
    cuts it), its ``InputShape`` and its time in ms."""
    return {"label": label, "cfg": cfg, "shape": shape, "ms": ms}


def _roofline_line(step: dict) -> None:
    """Print a measured step beside ``roofline/analytic.py``'s account and
    ``RooflineTerms(n_chips=1)`` on the H100's constants, with its bound
    share (the least time over the measured time), which must lie in
    (0, ROOFLINE_SHARE_MAX]."""
    import torch
    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import abstract_params
    from repro_torch.models.api import build_model
    from repro_torch.roofline import analytic
    from repro_torch.roofline.analysis import (RooflineTerms,
                                               model_flops_estimate)
    cfg, shape, ms = step["cfg"], step["shape"], step["ms"]
    api = build_model(cfg)
    tree = abstract_params(api, torch.float32)
    n_total = dryrun.count_params(tree)
    n_active = dryrun.moe_active_params(cfg, tree)
    # the measured train steps (8b, 13a) run make_train_step_fn's
    # default per-block remat
    acct = analytic.step_account(cfg, shape,
                                 window=api.effective_window(shape.seq_len),
                                 n_params_total=n_total,
                                 n_params_active=n_active, remat=True)
    kind = "train" if shape.kind == "train" else "forward"
    mf = model_flops_estimate(n_active, dryrun.tokens_per_step(cfg, shape),
                              kind)
    t = RooflineTerms(arch=cfg.name, shape=shape.name, mesh="1x1",
                      n_chips=1, hlo_flops=acct["flops"],
                      hlo_bytes=acct["bytes"], collective_bytes_per_dev=0.0,
                      model_flops=mf)
    share = t.step_time_lower_bound * 1e3 / ms
    mfu = mf / (t.peak_flops * ms / 1e3)
    print(f"roofline [{step['label']}]: {shape} layers={cfg.n_layers} "
          f"params={n_total:,} active={n_active:,} analytic flops="
          f"{acct['flops']:.4e} bytes={acct['bytes']:.4e} t_compute_ms="
          f"{t.compute_term * 1e3:.4f} t_memory_ms={t.memory_term * 1e3:.4f} "
          f"dominant={t.dominant} bound_ms="
          f"{t.step_time_lower_bound * 1e3:.4f} measured_ms={ms:.4f} "
          f"bound_share={share:.4f} model_flops={mf:.4e} "
          f"model_flop_share={mfu:.4f} (limit: 0 < bound share <= "
          f"{ROOFLINE_SHARE_MAX:g}) [{CARD}]", flush=True)
    if not 0 < share <= ROOFLINE_SHARE_MAX:
        raise AssertionError(f"{step['label']}: bound share {share:.4f} "
                             f"is outside (0, {ROOFLINE_SHARE_MAX:g}]: the "
                             "account or the timed window is wrong")


def phase_roofline_full(api, params) -> list:
    """17a on phase 4's full-width gemma-7b bf16 weights: the meta tree's
    parameter count must equal the card's exactly; the prefill step
    (``make_prefill_step_fn``, no grad) at 1 x FULL_PREFILL must launch
    B6 once a layer and no other kernel, and is timed with
    :func:`_median_ms`; so is the serve step (``make_serve_step_fn``) at
    batch FULL_DECODE[0] over a FULL_DECODE[1]-slot cache (the dense
    slot path, which must launch no kernel; the LM server runs the paged
    path, B1-B3, instead).  Returns the two measured steps."""
    import torch
    from repro_torch.configs.shapes import InputShape
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import (abstract_params,
                                          make_prefill_step_fn,
                                          make_serve_step_fn)
    t_phase = time.perf_counter()
    cfg = api.cfg
    n_card = sum(t.numel() for t in _leaves(params))
    n_meta = dryrun.count_params(abstract_params(api))
    print(f"17a parameter count: meta tree {n_meta:,}, the card's tree "
          f"{n_card:,} [{CARD}]", flush=True)
    if n_meta != n_card:
        raise AssertionError(f"the meta tree counts {n_meta:,} parameters, "
                             f"the card's {n_card:,}")
    torch.cuda.empty_cache()
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 17)
    shape = InputShape(f"prefill_{FULL_PREFILL}", FULL_PREFILL, 1,
                       "prefill")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, FULL_PREFILL),
                                     generator=gen, device=DEVICE)}
    step = make_prefill_step_fn(api, shape)
    steps = []
    with torch.no_grad():
        step(params, batch)
        _sync()
        _zero_counts()
        out = step(params, batch)
        _sync()
        counts = {k: v for k, v in _read_counts().items() if v}
        print(f"17a prefill: batch 1 x {FULL_PREFILL}, logits "
              f"{tuple(out.shape)} finite={bool(torch.isfinite(out).all())} "
              f"kernel_launches={json.dumps(counts)}", flush=True)
        if counts != {fa.B6: cfg.n_layers}:
            raise AssertionError(f"17a prefill launches {counts} != B6 x "
                                 f"{cfg.n_layers}")
        if not bool(torch.isfinite(out).all()):
            raise AssertionError("17a prefill logits not finite")
        ms = _median_ms(lambda: step(params, batch), reps=5, inner=3)
        steps.append(_measured("17a gemma-7b prefill (median)", cfg, shape,
                               ms))
        del out, batch
        B, slots = FULL_DECODE
        dshape = InputShape(f"decode_{slots}", slots, B, "decode")
        cache = api.init_cache(B, slots, window=api.effective_window(slots),
                               dtype=torch.bfloat16, device=DEVICE)
        tokens = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen,
                               device=DEVICE)
        serve = make_serve_step_fn(api, dshape)
        kv = sum(t.numel() * t.element_size()
                 for t in cache["scan"].values())
        ms = _median_ms(lambda: serve(params, cache, tokens), reps=5)
        _zero_counts()
        logits, _ = serve(params, cache, tokens)
        _sync()
        counts = {k: v for k, v in _read_counts().items() if v}
        ok = bool(torch.isfinite(logits).all())
        print(f"17a decode: batch {B} over {slots} slots, K/V "
              f"{kv / 2**30:.2f} GiB, logits {tuple(logits.shape)} "
              f"finite={ok}, kernel_launches={json.dumps(counts)}, "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card",
              flush=True)
        if counts:
            raise AssertionError(f"17a decode launches {counts}: the dense "
                                 "slot step runs no kernel")
        if not ok:
            raise AssertionError("17a decode logits not finite")
        steps.append(_measured("17a gemma-7b decode (median)", cfg, dshape,
                               ms))
        del cache, logits
    torch.cuda.empty_cache()
    print(f"phase 17a: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return steps


def phase_roofline(steps: list) -> None:
    """Phase 17: every measured step of 17a and of phases 8b, 9 and 13a
    against its bound (:func:`_roofline_line`)."""
    t0 = time.perf_counter()
    for step in steps:
        _roofline_line(step)
    print(f"phase 17: {time.perf_counter() - t0:.1f} s", flush=True)


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
    global CARD
    CARD = card
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
    _sync()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"init: gemma-7b {n_params / 1e9:.3f} B params bf16 in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card",
          flush=True)
    launches = {kernel: phase_main_path(api, params, label, kw, kernel)
                for label, kw, kernel in PATHS}

    # 5. full-width steps against the plain path
    phase_step_vs_plain(api, params)
    # 17a. the parameter count, and the full-width prefill and decode
    # steps timed for phase 17, on the same weights
    roofline_steps = phase_roofline_full(api, params)
    del params
    torch.cuda.empty_cache()

    # 7. the paper's loop
    launches["pseudo_voigt"] = phase_paper_loop()

    # 8. LM training: the flash-attention kernels against their plain
    # versions (before any weights are loaded), then the training path
    torch.cuda.empty_cache()
    fa_checks = phase_flash_kernels()
    train_launches, eval_launches, step = phase_training()
    roofline_steps.append(step)
    for name in fa_checks:
        launches[name] = train_launches[name] or eval_launches[name]

    # 9. the recurrent families: the scan kernels against their plain
    # versions, then zamba2-2.7b's and xlstm-1.3b's prefill and serving
    torch.cuda.empty_cache()
    scan_checks = phase_scan_kernels()
    zamba, step = phase_recurrent("zamba2-2.7b", {
        "ssd_scan": 54, "flash_attention": 9})
    roofline_steps.append(step)
    xlstm, step = phase_recurrent("xlstm-1.3b", {"mlstm_scan": 42})
    roofline_steps.append(step)
    launches["ssd_scan"] = zamba["ssd_scan"]
    launches["mlstm_scan"] = xlstm["mlstm_scan"]

    # 10. the MoE family, the VLM backbone and command-r-35b on the paged
    # path at their published widths
    torch.cuda.empty_cache()
    phase_moe()
    phase_vlm()
    phase_command_r()

    # 11. the data-center/edge bridge: the paper's flow on the port's
    # repro_torch.core, then gemma-7b through DisaggregatedEngine
    torch.cuda.empty_cache()
    phase_bridge_flow()
    fleet = phase_bridge_bf16()

    # 12. the paper's second DNN, the online frontend on phase 11's
    # weights (bf16, then float32) and the crossover analysis
    phase_frontend(*fleet, "bf16", exact=False)
    del fleet
    fleet = phase_bridge_f32()
    phase_frontend(*fleet, "f32", exact=True)
    del fleet
    phase_cookienetae()
    phase_crossover()

    # 13. the audio family (whisper-base: training, prefill, decode
    # consistency, serving) and the recurrent families' training
    torch.cuda.empty_cache()
    roofline_steps.append(phase_whisper()["step"])
    phase_recurrent_train("zamba2-2.7b")
    phase_recurrent_train("xlstm-1.3b")

    # 14. mesh serving: gemma-7b through the tensor-parallel paged engine
    # and the data-parallel front on positions that share the card
    torch.cuda.empty_cache()
    phase_mesh()

    # 15. sharded training: gemma-7b and deepseek-moe-16b at full width
    # over mesh positions that share the card
    torch.cuda.empty_cache()
    for name, n in phase_sharded_training().items():
        launches[name] += n

    # 16. sharded training of the VLM, audio, hybrid and ssm families
    torch.cuda.empty_cache()
    for name, n in phase_sharded_families().items():
        launches[name] += n

    # 17. the measured steps of 17a, 8b, 9 and 13a against their bound
    phase_roofline(roofline_steps)

    # each kernel's numbers at its main path's shapes
    numbers = {name: c["gemma-7b bf16"] for name, c in checks.items()}
    numbers["pseudo_voigt"] = pv_check
    numbers.update(fa_checks)
    numbers.update(scan_checks)
    rows = []
    for name, source, replaces in KERNELS:
        main_cfg = numbers[name]
        rows.append({
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}.cu",
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
    for v in (tree.values() if isinstance(tree, dict) else tree):
        if isinstance(v, (dict, list)):
            yield from _leaves(v)
        else:
            yield v


if __name__ == "__main__":
    main()
