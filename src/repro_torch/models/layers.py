"""Core transformer layers: QKV/out projections, the causal attention of
training and prefill, decode attention, MLPs, embedding and LM head.

The counterpart of ``repro/models/layers.py``.  Weights arrive already in
the compute dtype (``models/common.py``; ``transformer.forward`` casts
float32 masters once per call), so no per-call cast happens here, and the
mesh-only pieces of the reference (sharding constraints, the
optimization barrier, ``maybe_expand_kv``, which is the identity without
a mesh) have no counterpart.

Causal attention has the reference's three paths, and on the card a
fourth:
  * ``full``    — plain masked einsum softmax, for short sequences;
  * ``chunked`` — the online-softmax (flash-style) schedule in plain
                  PyTorch over chunks, for long sequences: a
                  sliding-window band or the causal diagonal;
  * ``decode``  — one query token against a (possibly rolling) KV cache;
  * on CUDA tensors, :func:`causal_attention` runs the flash-attention
    kernels (``kernels/flash_attention.py``, forward and backward), the
    TPU kernel these paths are the oracle cousins of.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kernel_ops
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


def project_out(p: Dict, attn_out: torch.Tensor, cfg: ArchConfig, *,
                bias: bool = True) -> torch.Tensor:
    """attn_out: (..., S, H, D) -> (..., S, d_model); ``bias=False``
    leaves out ``bo`` (a tensor-parallel shard's partial sum, whose bias
    is added once after the reduce)."""
    wo = p["wo"]                                     # (H, D, d)
    y = attn_out.reshape(*attn_out.shape[:-2], -1) @ wo.reshape(
        -1, wo.shape[-1])
    if bias and cfg.use_bias:
        y = y + p["bo"]
    return y


def _neg_inf(like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(NEG_INF, dtype=like.dtype, device=like.device)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: int = 0,
                   q_offset: int = 0) -> torch.Tensor:
    """q: (B,Sq,H,D); k/v: (B,Skv,Hkv,D) -> (B,Sq,H,D).  Scores in the
    input dtype then float32, weights back in ``q.dtype`` before PV, as
    the reference."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, Hkv, H // Hkv, D)
    scores = torch.einsum("bqkgd,bskd->bqkgs", qg, k).to(torch.float32)
    scores = scores / (D ** 0.5)
    qpos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= qpos - kpos < window
    scores = torch.where(mask[None, :, None, None, :], scores,
                         _neg_inf(scores))
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bqkgs,bskd->bqkgd", w, v)
    return out.reshape(B, Sq, H, D)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      window: int = 0, chunk: int = 512) -> torch.Tensor:
    """Causal (optionally sliding-window) attention over chunks of
    ``chunk`` queries, differentiable through autograd, in the reference's
    two schedules:
      * sliding window (``window + chunk < S``): each query chunk attends
        to its band of ``window + chunk`` keys (work O(S * window));
      * otherwise causal online softmax: each query chunk sweeps the key
        chunks up to the diagonal with a running max, sum and float32
        accumulator.
    The reference rematerializes each chunk in the backward pass; the
    port keeps autograd's saved chunks (O(S^2 / chunk) per layer), which
    ``transformer.forward``'s per-block checkpointing bounds to one layer
    at a time."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    C = min(chunk, S)
    if S % C:
        raise ValueError(f"sequence {S} is not a multiple of chunk {C}")
    nq = S // C
    scale = 1.0 / (D ** 0.5)
    qg = q.reshape(B, nq, C, Hkv, G, D)
    ar = torch.arange(C, device=q.device)
    outs = []

    if window and window + C < S:
        Lb = window + C                      # band length
        for i in range(nq):
            qpos = i * C + ar
            start = min(max(i * C + C - Lb, 0), S - Lb)
            kpos = start + torch.arange(Lb, device=q.device)
            s = torch.einsum("bqkgd,bskd->bqkgs", qg[:, i] * scale,
                             k[:, start:start + Lb]).to(torch.float32)
            mask = ((kpos[None, :] <= qpos[:, None])
                    & (qpos[:, None] - kpos[None, :] < window))
            s = torch.where(mask[None, :, None, None, :], s, _neg_inf(s))
            w = torch.softmax(s, dim=-1).to(q.dtype)
            outs.append(torch.einsum("bqkgs,bskd->bqkgd", w,
                                     v[:, start:start + Lb]))
        return torch.stack(outs, dim=1).reshape(B, S, H, D)

    for i in range(nq):
        q_i = qg[:, i] * scale
        qpos = i * C + ar
        m = torch.full((B, C, Hkv, G), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, C, Hkv, G), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, C, Hkv, G, D), dtype=torch.float32,
                          device=q.device)
        for j in range(i + 1):               # chunks past the diagonal skip
            kpos = j * C + ar
            s = torch.einsum("bqkgd,bskd->bqkgs", q_i,
                             k[:, j * C:(j + 1) * C]).to(torch.float32)
            mask = kpos[None, :] <= qpos[:, None]
            if window:
                mask &= (qpos[:, None] - kpos[None, :]) < window
            s = torch.where(mask[None, :, None, None, :], s, _neg_inf(s))
            m_new = torch.maximum(m, s.amax(dim=-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bqkgs,bskd->bqkgd", p.to(q.dtype),
                v[:, j * C:(j + 1) * C]).to(torch.float32)
            m = m_new
        outs.append((acc / torch.clamp(l[..., None], min=1e-30)).to(q.dtype))
    return torch.stack(outs, dim=1).reshape(B, S, H, D)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     window: int = 0, chunk_threshold: int = 2048,
                     chunk: int = 512,
                     use_kernel: Optional[bool] = None) -> torch.Tensor:
    """q (B,S,H,D), k/v (B,S,Hkv,D) -> (B,S,H,D), causal.  On the kernel
    path (``use_kernel``, or CUDA tensors when it is None) the
    flash-attention kernels, forward and backward; otherwise the
    reference's split on sequence length: :func:`full_attention` up to
    ``chunk_threshold``, :func:`chunked_attention` above it."""
    if kernel_ops.resolve_use_kernel(q, use_kernel):
        return kernel_ops.flash_attention_bshd(q, k, v, causal=True,
                                               window=window,
                                               use_kernel=True)
    if q.shape[1] <= chunk_threshold:
        return full_attention(q, k, v, causal=True, window=window)
    return chunked_attention(q, k, v, window=window, chunk=chunk)


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
    s = torch.where(valid[:, None, None, :], s, _neg_inf(s))
    w = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", w, v_cache)
    return out.reshape(B, 1, H, D)


def apply_mlp(p: Dict, x: torch.Tensor, cfg: ArchConfig, *,
              bias: bool = True) -> torch.Tensor:
    """The dense MLP; ``bias=False`` leaves out ``b_down`` (as
    :func:`project_out` leaves out ``bo``)."""
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
    if bias and cfg.use_bias:
        y = y + p["b_down"]
    return y


def embed_tokens(p: Dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["embedding"][tokens]


def lm_logits(head_p: Optional[Dict], embed_p: Dict, x: torch.Tensor,
              tie: bool) -> torch.Tensor:
    w = embed_p["embedding"].T if tie else head_p["w"]
    return (x @ w).to(torch.float32)
