"""Core transformer layers: QKV/out projections, decode attention, MLPs,
embedding and LM head.

The counterpart of ``repro/models/layers.py``.  Weights arrive already in
the compute dtype (``models/common.py``), so no per-call cast happens and
the mesh-only pieces of the reference (sharding constraints, the
optimization barrier) have no counterpart.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import common
from repro_torch.models.common import apply_rope

NEG_INF = -1e30


def _headwise_rmsnorm(x: torch.Tensor, scale: torch.Tensor,
                      eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def project_qkv(p: Dict, x: torch.Tensor, positions: torch.Tensor,
                cfg: ArchConfig
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (..., S, d) -> q (..., S, H, D), k/v (..., S, Hkv, D), RoPE'd."""
    lead = x.shape[:-1]

    def proj(w):                                     # w: (d, heads, D)
        return (x @ w.reshape(w.shape[0], -1)).reshape(*lead, *w.shape[1:])

    q, k, v = proj(p["wq"]), proj(p["wk"]), proj(p["wv"])
    if cfg.use_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.qk_norm:
        q = _headwise_rmsnorm(q, p["q_norm_scale"])
        k = _headwise_rmsnorm(k, p["k_norm_scale"])
    if cfg.max_decoder_positions:      # learned positions handled elsewhere
        return q, k, v
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def project_out(p: Dict, attn_out: torch.Tensor,
                cfg: ArchConfig) -> torch.Tensor:
    """attn_out: (..., S, H, D) -> (..., S, d_model)."""
    wo = p["wo"]                                     # (H, D, d)
    y = attn_out.reshape(*attn_out.shape[:-2], -1) @ wo.reshape(
        -1, wo.shape[-1])
    if cfg.use_bias:
        y = y + p["bo"]
    return y


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, slot_positions: torch.Tensor,
                     pos: torch.Tensor, *, window: int = 0) -> torch.Tensor:
    """q: (B,1,H,D); caches: (B,S_slots,Hkv,D); slot_positions: (B,S_slots)
    absolute token position per slot (-1 = empty); pos: (B,) the current
    decode position.  Scores in the input dtype then float32, weights back
    in ``q.dtype`` before PV, as the reference."""
    B, _, H, D = q.shape
    Hkv = k_cache.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Hkv, G, D)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache).to(torch.float32)
    s = s / (D ** 0.5)
    valid = (slot_positions >= 0) & (slot_positions <= pos[:, None])
    if window:
        valid &= (pos[:, None] - slot_positions) < window
    s = torch.where(valid[:, None, None, :], s,
                    torch.tensor(NEG_INF, dtype=s.dtype, device=s.device))
    w = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", w, v_cache)
    return out.reshape(B, 1, H, D)


def apply_mlp(p: Dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if cfg.mlp_type in ("swiglu", "geglu"):
        act = "silu" if cfg.mlp_type == "swiglu" else "gelu"
        g = common.activation(act, x @ p["w_gate"])
        u = x @ p["w_up"]
        if cfg.use_bias:
            u = u + p["b_up"]
        h = g * u
    else:
        h = x @ p["w_up"]
        if cfg.use_bias:
            h = h + p["b_up"]
        h = common.activation("gelu", h)
    y = h @ p["w_down"]
    if cfg.use_bias:
        y = y + p["b_down"]
    return y


def embed_tokens(p: Dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["embedding"][tokens]


def lm_logits(head_p: Optional[Dict], embed_p: Dict, x: torch.Tensor,
              tie: bool) -> torch.Tensor:
    w = embed_p["embedding"].T if tie else head_p["w"]
    return (x @ w).to(torch.float32)
