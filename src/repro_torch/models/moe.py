"""Mixture-of-Experts layer: GShard-style capacity dispatch.

The counterpart of ``repro/models/moe.py``.  Tokens are grouped by the
leading axis of ``x`` (G groups of S tokens); each group computes its own
expert capacity ``C = ceil(S * k / E * capacity_factor)``, and a token's
slot in an expert (and whether it is dropped past C) depends on every
earlier (token, choice) of its group, in (token, choice) order.  The
callers keep the reference's groups: ``forward`` B groups of S,
``paged_step`` B lanes of C rows (padding rows included),
``decode_step`` B groups of 1, and ``ragged_step`` the whole flat stream,
its bucket padding included, as one (1, T) group.

The router runs in float32 from the router weights as stored; the
dispatch and combine tensors are made in the compute dtype (the combine
with the gates rounded to it), as the reference does.  The expert
products and the dispatch/combine contractions are plain products that
the reference computes outside any Pallas kernel, so they stay
``torch.einsum``.  The counterpart of the reference's expert-parallel
``shard_map`` combine: a tensor-parallel shard of the port
(``transformer._tp_ffn``, serving and training) runs
:func:`routed_experts` on its own experts with the gathered router
logits, and the step reduces the shards' partial outputs (in training,
through a reduce whose backward hands every shard the summed output
gradient).

The load-balance loss is kept as its two per-expert means
(:func:`balance_means`): a data-parallel step averages each over its
slices before the product, as the reference's global-batch aux is, and
a tensor-parallel layer takes them from one shard, so the aux counts
once.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.models import common, layers
from repro_torch.models.common import dense_init_, fan_in_std


# ---------------------------------------------------------------------------
def moe_params(cfg: ArchConfig, n: int, g: torch.Generator, *, device,
               dtype: torch.dtype) -> Dict:
    """``n`` stacked MoE layers (router, routed experts, shared experts)
    with the reference's init scales, weights in ``dtype``."""
    mo = cfg.moe
    assert mo is not None
    d, E, h = cfg.d_model, mo.n_experts, mo.d_expert

    def empty(*shape):
        return torch.empty(shape, dtype=dtype, device=device)

    p = {"router": empty(n, d, E), "experts_w_gate": empty(n, E, d, h),
         "experts_w_up": empty(n, E, d, h),
         "experts_w_down": empty(n, E, h, d)}
    for l in range(n):
        dense_init_(p["router"][l], g, std=fan_in_std((d,)))
        dense_init_(p["experts_w_gate"][l], g, std=fan_in_std((d,)))
        dense_init_(p["experts_w_up"][l], g, std=fan_in_std((d,)))
        dense_init_(p["experts_w_down"][l], g, std=fan_in_std((h,)))
    if mo.n_shared_experts:
        from repro_torch.models.transformer import mlp_params
        p["shared"] = mlp_params(cfg, n, g, device=device, dtype=dtype,
                                 d_ff=mo.d_expert * mo.n_shared_experts)
    return p


def expert_capacity(n_tokens_per_group: int, mo: MoEConfig) -> int:
    c = math.ceil(n_tokens_per_group * mo.experts_per_token
                  / mo.n_experts * mo.capacity_factor)
    return max(1, c)


# ---------------------------------------------------------------------------
def route_topk(logits: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (..., E) -> (gates (..., k), indices (..., k)): softmax
    probabilities in float32, the top k, renormalised over the k."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(dim=-1, keepdim=True), 1e-9)
    return gates, idx


def balance_means(probs: torch.Tensor, dispatch_counts: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean prob_e, mean dispatch_e), each (E,) float32, over (G, S, E)
    router probabilities and 0/1 dispatch counts."""
    return (probs.mean(dim=(0, 1)),
            dispatch_counts.to(torch.float32).mean(dim=(0, 1)))


def balance_loss(means: Tuple[torch.Tensor, torch.Tensor],
                 n_experts: int) -> torch.Tensor:
    """The GShard aux loss (the reference's ``load_balance_loss``) from
    :func:`balance_means`: E * sum_e(mean prob_e * mean dispatch_e)."""
    me, ce = means
    return n_experts * torch.sum(me * ce)


def router_logits(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """x (G, S, d) -> the router's float32 logits (G, S, E) over the
    experts of ``p["router"]``'s columns."""
    return torch.einsum("gsd,de->gse", x.to(torch.float32),
                        p["router"].to(torch.float32))


def _route(logits: torch.Tensor, mo: MoEConfig, C: int):
    """The capacity bookkeeping both dispatches share, from the layer's
    router logits (G,S,E): (gates (G,S,k), idx (G,S,k), choice (G,S,k,E)
    one-hot, pos_in_e (G,S,k,E) earlier claims on the same expert, keep
    (G,S,k,E) 0/1, the balance means)."""
    B, S, _ = logits.shape
    E, k = mo.n_experts, mo.experts_per_token
    probs = torch.softmax(logits, dim=-1)
    gates, idx = route_topk(logits, k)
    choice = F.one_hot(idx, E).to(torch.float32)            # (G,S,k,E)
    # slot 0 of token t precedes slot 0 of token t + 1 in the cumsum
    flat = choice.reshape(B, S * k, E)
    pos_in_e = (torch.cumsum(flat, dim=1) - flat).reshape(B, S, k, E)
    keep = choice * (pos_in_e < C)
    return (gates, idx, choice, pos_in_e, keep,
            balance_means(probs, keep.sum(dim=2)))


def _experts(p: Dict, xe: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The routed experts' gated MLPs over their capacity slabs xe
    (E, G, C, d) -> (E, G, C, d)."""
    act = "silu" if cfg.mlp_type == "swiglu" else "gelu"
    g = torch.einsum("egcd,edh->egch", xe, p["experts_w_gate"])
    u = torch.einsum("egcd,edh->egch", xe, p["experts_w_up"])
    h = common.activation(act, g) * u
    return torch.einsum("egch,ehd->egcd", h, p["experts_w_down"])


# ---------------------------------------------------------------------------
def apply_moe(p: Dict, x: torch.Tensor, cfg: ArchConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (G, S, d) -> (y (G, S, d), aux float32 scalar), G the capacity
    group axis.  Dropped (token, choice) pairs contribute nothing; the
    shared experts see every token.  ``cfg.moe.impl`` picks the dispatch:
    "gshard" (one-hot einsums) or "gather"."""
    mo = cfg.moe
    assert mo is not None
    y, means = routed_experts(p, x, cfg, router_logits(p, x))
    if mo.n_shared_experts:
        y = y + layers.apply_mlp(p["shared"], x, cfg)
    return y, balance_loss(means, mo.n_experts)


def routed_experts(p: Dict, x: torch.Tensor, cfg: ArchConfig,
                   logits: torch.Tensor, e0: int = 0, stages=None
                   ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                  torch.Tensor]]:
    """The routed experts' share of the MoE output, (y (G, S, d), the
    layer's :func:`balance_means`):
    the layer's routes and drops come from its router ``logits`` (G, S,
    E) over all E experts, and ``p`` holds experts ``e0 .. e0 + E_p - 1``
    of them (all E by default), so a tensor-parallel shard adds the
    outputs of its own experts only.  ``stages`` (a traced serving step's
    ``serving.tracing.MoEStages``) gets a mark at each stage boundary:
    the route, the dispatch before and after the experts, which are not
    timed."""
    mo = cfg.moe
    assert mo is not None
    C = expert_capacity(x.shape[1], mo)
    n_local = p["experts_w_down"].shape[0]
    if stages is not None:
        stages.mark(x.device, "route")
    gates, idx, choice, pos_in_e, keep, means = _route(logits, mo, C)
    if stages is not None:
        stages.mark(x.device, "dispatch")
    if mo.impl == "gather":
        y = _dispatch_gather(p, x, cfg, C, gates, idx, choice, pos_in_e,
                             keep, e0, n_local, stages)
    else:
        y = _dispatch_gshard(p, x, cfg, C, gates, choice, pos_in_e,
                             keep[..., e0:e0 + n_local], stages)
    if stages is not None:
        stages.mark(x.device, None)
    return y, means


def _timed_experts(p: Dict, xe: torch.Tensor, cfg: ArchConfig,
                   stages) -> torch.Tensor:
    """:func:`_experts`, left out of the dispatch stage's time: the
    stretch after it is the dispatch's again (the combine)."""
    if stages is None:
        return _experts(p, xe, cfg)
    stages.mark(xe.device, None)
    ye = _experts(p, xe, cfg)
    stages.mark(xe.device, "dispatch")
    return ye


def _dispatch_gshard(p: Dict, x: torch.Tensor, cfg: ArchConfig, C: int,
                     gates, choice, pos_in_e, keep,
                     stages=None) -> torch.Tensor:
    """The one-hot dispatch and combine einsums over the experts of ``p``
    (``keep`` cut to them)."""
    dt = x.dtype
    # capacity-slot one-hot (G,S,k,C), all zero past C as the reference's
    # one_hot; dispatch and combine in the compute dtype
    slot_c = torch.sum(pos_in_e * choice, dim=-1)
    slot = (slot_c[..., None] == torch.arange(
        C, device=x.device, dtype=slot_c.dtype)).to(dt)
    keep_c = keep.to(dt)
    dispatch = torch.einsum("gske,gskc->gsec", keep_c, slot)
    combine = torch.einsum("gske,gsk,gskc->gsec", keep_c, gates.to(dt), slot)
    xe = torch.einsum("gsec,gsd->egcd", dispatch, x)
    ye = _timed_experts(p, xe, cfg, stages)
    return torch.einsum("gsec,egcd->gsd", combine, ye)


def _dispatch_gather(p: Dict, x: torch.Tensor, cfg: ArchConfig, C: int,
                     gates, idx, choice, pos_in_e, keep, e0: int,
                     n_local: int, stages=None) -> torch.Tensor:
    """The gather dispatch: integer routing tables instead of one-hot
    einsums (zero-FLOP routing), then the plain gather combine, over
    experts ``e0 .. e0 + n_local - 1``.  Same routes, drops and result as
    the "gshard" dispatch."""
    B, S, d = x.shape
    k = idx.shape[-1]
    dt = x.dtype
    mine = ((idx >= e0) & (idx < e0 + n_local)).to(keep.dtype)
    keep_slot = keep.sum(dim=-1) * mine                     # (G,S,k) 0/1
    idx_l = torch.clamp(idx - e0, 0, n_local - 1)
    slot_c = torch.sum(pos_in_e * choice, dim=-1).long()    # (G,S,k)
    # dropped pairs sit past C: they add 0 at slot C - 1, as the
    # reference's out-of-range scatter adds nothing
    slot_in = torch.clamp(slot_c, max=C - 1)
    # routing table (G, E_p, C): source token + 1, 0 = empty slot; kept
    # (e, c) pairs are unique per group
    s_idx = torch.arange(S, device=x.device)[None, :, None].expand(B, S, k)
    g_idx = torch.arange(B, device=x.device)[:, None, None].expand(B, S, k)
    buf = torch.zeros((B, n_local, C), dtype=torch.long, device=x.device)
    buf.index_put_((g_idx, idx_l, slot_in),
                   ((s_idx + 1) * keep_slot).long(), accumulate=True)
    valid = buf > 0
    tok = torch.clamp_min(buf - 1, 0)
    xe = x[torch.arange(B, device=x.device)[:, None, None], tok]  # (G,E,C,d)
    xe = (xe * valid[..., None].to(dt)).transpose(0, 1)      # (E,G,C,d)
    ye = _timed_experts(p, xe, cfg, stages)
    w = (gates * keep_slot).to(dt)                          # (G,S,k)
    ye_g = ye.transpose(0, 1)                               # (G,E,C,d)
    yk = ye_g[g_idx, idx_l, slot_in]                        # (G,S,k,d)
    return torch.einsum("gsk,gskd->gsd", w, yk)
