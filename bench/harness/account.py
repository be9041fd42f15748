"""FLOP and byte counts of a served step, from the step's own decision.

A step is the list of its segments, one for each scheduled request:
``(start, rows, useful)``: the position of the segment's first token,
the rows the step computed for it (fed tokens and draft tokens), and the
rows the request kept (prompt tokens, and of a draft segment the fed
token and the drafts that were accepted).  Nothing here looks at how the
program cut the work into kernels, so the counts stay where they are
whatever implements the step.

The paged attention read (B1) of one layer and segment attends, for the
query at position ``p``, to the ``min(p + 1, window)`` keys ending at
``p``.  Its least time is the larger of its FLOPs over the card's peak
and its bytes over the card's bandwidth, where each K/V byte that the
segment attends is counted once a layer, and the queries are read and
the outputs written once.

The useful FLOPs of a step are 2 x the active parameters (the embedding
lookup costs none; an MoE layer's active parameters are its router, its
top-k routed experts and its shared experts) x the kept rows, plus the
attention over the kept rows' spans.  An MoE layer's capacity slots and
its dispatch and combine products are not useful work: another dispatch
does without them.  (The program's ``roofline/analytic.py`` counts the
dispatch; this copy deliberately does not.)
"""
from __future__ import annotations

from typing import Dict, Iterable, Sequence, Tuple

from bench.harness import model_config as mc

# NVIDIA H100 SXM, dense bf16 on the tensor cores, and HBM3 bandwidth
# (NVIDIA's data sheet, at the 700 W limit)
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
KV_BYTES = 2                    # bf16 pools
ACT_BYTES = 2                   # bf16 queries and outputs

Segment = Tuple[int, int, int]  # (start, rows, useful)


def span_sum(start: int, rows: int, window: int) -> int:
    """Sum over positions p in [start, start + rows) of the keys p
    attends to: min(p + 1, window) (window 0: p + 1)."""
    if rows <= 0:
        return 0
    lo, hi = start + 1, start + rows            # p + 1 runs over [lo, hi]
    if not window or hi <= window:
        return (lo + hi) * rows // 2
    if lo >= window:
        return window * rows
    below = (lo + window - 1) * (window - lo) // 2   # p + 1 in [lo, w)
    return below + window * (hi - window + 1)


def kv_tokens(start: int, rows: int, window: int) -> int:
    """Distinct keys the segment's queries attend to."""
    last = start + rows - 1
    first = max(0, start - window + 1) if window else 0
    return last - first + 1


def b1_counts(cfg: Dict, segments: Iterable[Segment]) -> Tuple[float, float]:
    """(FLOPs, bytes) of the step's paged attention reads over all
    layers."""
    L = cfg["num_hidden_layers"]
    H, Hkv, D = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 mc.head_dim(cfg))
    w = mc.window(cfg)
    flops = bytes_ = 0.0
    for start, rows, _ in segments:
        flops += 4.0 * H * D * span_sum(start, rows, w)
        bytes_ += (2.0 * Hkv * D * KV_BYTES * kv_tokens(start, rows, w)
                   + 2.0 * rows * H * D * ACT_BYTES)
    return flops * L, bytes_ * L


def b1_least_s(cfg: Dict, segments: Sequence[Segment]) -> float:
    """The least time the card could take for the step's B1 calls."""
    f, b = b1_counts(cfg, segments)
    return max(f / PEAK_FLOPS, b / PEAK_BYTES)


def active_params(cfg: Dict) -> int:
    """Parameters a token passes through, the output head included and
    the embedding table left out."""
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    H, Hkv, D = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 mc.head_dim(cfg))
    attn = d * H * D * 2 + d * Hkv * D * 2
    gated = cfg["hidden_act"] == "silu"

    def mlp(ff: int) -> int:
        return (3 if gated else 2) * d * ff

    head = d * cfg["vocab_size"]
    if not mc.is_moe(cfg):
        return L * (attn + mlp(cfg["intermediate_size"])) + head
    n_dense = cfg["first_k_dense_replace"]
    h = cfg["moe_intermediate_size"]
    moe = (d * cfg["n_routed_experts"]                 # router
           + cfg["num_experts_per_tok"] * 3 * d * h    # routed experts
           + cfg["n_shared_experts"] * 3 * d * h)      # shared experts
    return (n_dense * (attn + mlp(cfg["intermediate_size"]))
            + (L - n_dense) * (attn + moe) + head)


def useful_flops(cfg: Dict, segments: Iterable[Segment]) -> float:
    """The model's useful FLOPs in the step's kept rows."""
    L = cfg["num_hidden_layers"]
    H, D = cfg["num_attention_heads"], mc.head_dim(cfg)
    w = mc.window(cfg)
    n = active_params(cfg)
    total = 0.0
    for start, _, useful in segments:
        total += 2.0 * n * useful + L * 4.0 * H * D * span_sum(start, useful,
                                                               w)
    return total
