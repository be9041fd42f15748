"""Decoder-only transformer LM (dense and MoE families, and the VLM's
text backbone): parameters, the training forward and loss, the dense-slot
decode step and the paged serving steps (rectangular ``paged_step`` and
flat-token ``ragged_step``).

The counterpart of ``repro/models/transformer.py``.  Parameters keep the
reference's layout: every leaf of ``params["blocks"]`` has a leading
layer axis, and an MoE config's ``first_dense_layers`` are an unstacked
list, ``params["head_blocks"]``, run before them.  The port runs eagerly:
a Python loop over layers takes the place of ``lax.scan`` (and one
recomputing autograd node per block, :func:`remat_node`, that of
``jax.checkpoint``), and the
KV caches are one ``(n_layers, ...)`` tensor per leaf over all layers
(head block i uses layer i), updated in place through per-layer views
instead of being rebuilt and donated every step.

``tp_ragged_step`` and ``tp_paged_step`` run the serving steps
tensor-parallel over mesh positions from one controller (a
:class:`TPPlan`): each position runs every layer on its shard of the
parameters and its own pools, and a reduce follows a layer's partial sums
only where the specs cut the contraction, in fixed order on position 0's
device, so every position sees the same bits.  ``ragged_step`` and
``paged_step`` are their one-position case, so the serving steps have one
layer loop.  ``tp_forward`` and ``tp_loss_fn`` are the training forward
and loss over the same layer loop (``forward`` and ``loss_fn`` their
one-position case), with the reduces and gathers autograd Functions
whose backward is a reduce or a reduce-scatter; ``tp_loss_fn`` adds
data-parallel slices' loss sums before dividing.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device, seeded_generator
from repro_torch.models import layers, moe as moe_lib
from repro_torch.models.common import (apply_norm, cast_weights, dense_init_,
                                       embed_init_, fan_in_std, norm_params)


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------
def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in ("dense", "moe", "vlm"):
        raise NotImplementedError(
            f"{cfg.name}: this module serves the dense and MoE transformer "
            "families and the VLM's text backbone (zamba2 and xLSTM are "
            "models/recurrent.py; the audio family is models/encdec.py)")


def attention_params(cfg: ArchConfig, n: int, g: torch.Generator, *,
                     device, dtype: torch.dtype) -> Dict:
    """``n`` stacked attention layers with the reference's init scales
    (``layers.attention_params``), weights in ``dtype``."""
    d, L = cfg.d_model, cfg.n_layers
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim

    def empty(*shape):
        return torch.empty(shape, dtype=dtype, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    attn = {"wq": empty(n, d, H, D), "wk": empty(n, d, Hkv, D),
            "wv": empty(n, d, Hkv, D), "wo": empty(n, H, D, d)}
    # reference: dense_init((H, D, d), in_axis=0, scale=1/sqrt(2L)) then
    # rescaled by sqrt(D) / sqrt(H * D), i.e. std = 1 / (sqrt(2L) * H)
    wo_std = (fan_in_std((H, D, d), scale=1.0 / (2 * L) ** 0.5)
              * D ** 0.5 / (H * D) ** 0.5)
    for l in range(n):
        dense_init_(attn["wq"][l], g, std=fan_in_std((d,)))
        dense_init_(attn["wk"][l], g, std=fan_in_std((d,)))
        dense_init_(attn["wv"][l], g, std=fan_in_std((d,)))
        dense_init_(attn["wo"][l], g, std=wo_std)
    if cfg.use_bias:
        attn.update(bq=zeros(n, H, D), bk=zeros(n, Hkv, D),
                    bv=zeros(n, Hkv, D), bo=zeros(n, d))
    if cfg.qk_norm:
        attn["q_norm_scale"] = torch.ones((n, D), device=device)
        attn["k_norm_scale"] = torch.ones((n, D), device=device)
    return attn


def mlp_params(cfg: ArchConfig, n: int, g: torch.Generator, *, device,
               dtype: torch.dtype, d_ff: Optional[int] = None) -> Dict:
    """``n`` stacked MLPs of width ``d_ff`` (default ``cfg.d_ff``) with the
    reference's init scales (``layers.mlp_params``), weights in
    ``dtype``."""
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    gated = cfg.mlp_type in ("swiglu", "geglu")

    def empty(*shape):
        return torch.empty(shape, dtype=dtype, device=device)

    mlp = {"w_up": empty(n, d, ff), "w_down": empty(n, ff, d)}
    if gated:
        mlp["w_gate"] = empty(n, d, ff)
    for l in range(n):
        if gated:
            dense_init_(mlp["w_gate"][l], g, std=fan_in_std((d,)))
        dense_init_(mlp["w_up"][l], g, std=fan_in_std((d,)))
        dense_init_(mlp["w_down"][l], g, std=fan_in_std((ff,)))
    if cfg.use_bias:
        mlp.update(b_up=torch.zeros((n, ff), dtype=dtype, device=device),
                   b_down=torch.zeros((n, d), dtype=dtype, device=device))
    return mlp


def _stacked_blocks(cfg: ArchConfig, n: int, g: torch.Generator, *,
                    use_moe: bool, device, dtype: torch.dtype) -> Dict:
    """``n`` stacked blocks: norms, attention, and an MoE layer or a dense
    MLP (of ``moe.dense_d_ff`` for an MoE config's leading dense layers,
    as the reference's ``_block_params``)."""
    d, kw = cfg.d_model, dict(device=device, dtype=dtype)
    blocks = {"attn_norm": norm_params(cfg.norm_type, d, cfg.use_bias, n=n,
                                       device=device),
              "attn": attention_params(cfg, n, g, **kw)}
    if not cfg.parallel_block:
        blocks["mlp_norm"] = norm_params(cfg.norm_type, d, cfg.use_bias,
                                         n=n, device=device)
    if use_moe:
        blocks["moe"] = moe_lib.moe_params(cfg, n, g, **kw)
    else:
        d_ff = cfg.d_ff
        if cfg.moe is not None and cfg.moe.first_dense_layers:
            d_ff = cfg.moe.dense_d_ff or cfg.moe.d_expert
        blocks["mlp"] = mlp_params(cfg, n, g, d_ff=d_ff, **kw)
    return blocks


def init_params(cfg: ArchConfig, *, seed: int = 0, device="cuda",
                dtype: torch.dtype = torch.bfloat16) -> Dict:
    """Random parameters with the reference's shapes and init scales, from
    a ``torch.Generator`` seeded with ``seed`` on ``device``.  Weights are
    stored in ``dtype`` (the compute dtype); norms stay float32.  An MoE
    config's ``first_dense_layers`` become the list ``head_blocks``."""
    _check_family(cfg)
    dev = resolve_device(device)
    g = seeded_generator(dev, seed)
    d, V = cfg.d_model, cfg.vocab_size
    kw = dict(device=dev, dtype=dtype)
    n_head = cfg.moe.first_dense_layers if cfg.moe else 0
    head_blocks = [
        layer_params(_stacked_blocks(cfg, 1, g, use_moe=False, **kw), 0)
        for _ in range(n_head)]
    blocks = _stacked_blocks(cfg, cfg.n_layers - n_head, g,
                             use_moe=cfg.moe is not None, **kw)
    final = norm_params(cfg.norm_type, d, cfg.use_bias, n=1, device=dev)
    p = {"embed": {"embedding": embed_init_(torch.empty((V, d), **kw), g)},
         "final_norm": {k: v[0] for k, v in final.items()},
         "blocks": blocks}
    if head_blocks:
        p["head_blocks"] = head_blocks
    if not cfg.tie_embeddings:
        p["head"] = {"w": dense_init_(torch.empty((d, V), **kw), g,
                                      std=fan_in_std((d,)))}
    return p


def layer_params(blocks: Dict, l: int) -> Dict:
    """Layer ``l``'s parameters: views into the stacked leaves."""
    return {k: layer_params(v, l) if isinstance(v, dict) else v[l]
            for k, v in blocks.items()}


def _layers(params: Dict, cfg: ArchConfig):
    """Each layer's parameters in order: the unstacked ``head_blocks``,
    then views into the stacked ``blocks``."""
    head = params.get("head_blocks", [])
    yield from head
    for l in range(cfg.n_layers - len(head)):
        yield layer_params(params["blocks"], l)


def _embed(params: Dict, tokens: torch.Tensor,
           cfg: ArchConfig) -> torch.Tensor:
    x = layers.embed_tokens(params["embed"], tokens.long())
    if cfg.scale_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    return x


def _finish(params: Dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    x = apply_norm(cfg.norm_type, params["final_norm"], x)
    return layers.lm_logits(params.get("head"), params["embed"], x,
                            cfg.tie_embeddings)


def _mlp_residual(bp: Dict, x: torch.Tensor, xn: torch.Tensor,
                  attn: torch.Tensor, cfg: ArchConfig
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The residual adds after attention: (x, the MoE layer's
    load-balance loss, or None for a dense MLP).  The MoE layer's capacity
    groups are x's leading axis; the flat stream (T, d) of ``ragged_step``
    is one group, as the reference's (1, T, d)."""
    if cfg.parallel_block:
        return x + attn + layers.apply_mlp(bp["mlp"], xn, cfg), None
    x = x + attn
    xm = apply_norm(cfg.norm_type, bp["mlp_norm"], x)
    if "moe" in bp:
        flat = xm.dim() == 2
        y, aux = moe_lib.apply_moe(bp["moe"], xm[None] if flat else xm, cfg)
        return x + (y[0] if flat else y), aux
    return x + layers.apply_mlp(bp["mlp"], xm, cfg), None


# ---------------------------------------------------------------------------
# Forward (train / prefill) and loss: the one-position case of tp_forward
# ---------------------------------------------------------------------------
def forward(params: Dict, tokens: torch.Tensor, cfg: ArchConfig, *,
            window: int = 0, extra_embeds: Optional[torch.Tensor] = None,
            compute_dtype: torch.dtype = torch.bfloat16,
            attn_chunk: int = 512, remat: bool = True,
            use_kernel: Optional[bool] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits (B, S_extra + S, V) float32, MoE aux
    scalar): the training and prefill forward.  ``extra_embeds``
    (B, S_extra, d_model), already-projected frontend embeddings (the
    VLM's patches), are prepended to the token embeddings.

    Every float leaf of ``params`` but the norms, the other float32 keys
    and the MoE router (read in float32 from its stored precision, as the
    reference reads it) is cast to ``compute_dtype`` once per call,
    differentiably, so float32 masters train as the reference's do (a
    leaf already in ``compute_dtype`` is used as is).  With ``remat`` each
    block runs as one :func:`remat_node` node when autograd records, so the
    backward pass recomputes its insides.
    Attention follows ``layers.causal_attention``'s ``use_kernel`` rule.
    aux sums the MoE layers' load-balance losses (0 for the dense
    family).  The one-position case of :func:`tp_forward`."""
    _check_family(cfg)
    plan = tp_plan(cfg, None, [tokens.device])
    logits, means = tp_forward(
        [params], [tokens], cfg, plan, window=window,
        extra_embeds=None if extra_embeds is None else [extra_embeds],
        compute_dtype=compute_dtype, attn_chunk=attn_chunk, remat=remat,
        use_kernel=use_kernel)
    return logits, _balance_aux([means], cfg, logits.device)


def lm_loss_parts(logits: torch.Tensor, labels: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
    """The sums :func:`lm_loss` divides, over the kept positions (label
    -1 = ignore) of logits (B, S, V) float32: ``nll`` (the negative
    log-likelihoods), ``z`` (the squared logsumexps) and ``tokens``.  A
    data-parallel step adds its slices' parts before dividing."""
    mask = (labels >= 0).to(torch.float32)
    labels_c = torch.clamp(labels, min=0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels_c[..., None])[..., 0]
    nll = (logz - gold) * mask
    return {"nll": nll.sum(), "z": ((logz * mask) ** 2).sum(),
            "tokens": mask.sum()}


def lm_loss_from_parts(parts: Dict[str, torch.Tensor],
                       aux: Optional[torch.Tensor] = None,
                       aux_weight: float = 0.0, z_loss: float = 1e-4
                       ) -> Tuple[torch.Tensor, Dict]:
    """:func:`lm_loss` from (summed) :func:`lm_loss_parts`."""
    denom = torch.clamp(parts["tokens"], min=1.0)
    ce = parts["nll"] / denom
    zl = z_loss * parts["z"] / denom
    loss = ce + zl
    metrics = {"ce": ce, "z_loss": zl, "tokens": parts["tokens"]}
    if aux is not None and aux_weight:
        loss = loss + aux_weight * aux
        metrics["moe_aux"] = aux
    return loss, metrics


def lm_loss(logits: torch.Tensor, labels: torch.Tensor,
            aux: Optional[torch.Tensor] = None, aux_weight: float = 0.0,
            z_loss: float = 1e-4) -> Tuple[torch.Tensor, Dict]:
    """Cross-entropy with label -1 = ignore, plus the z-loss
    ``z_loss * mean(logsumexp^2)`` over the kept positions.  logits
    (B, S, V) float32.  Returns (loss, {"ce", "z_loss", "tokens"})."""
    return lm_loss_from_parts(lm_loss_parts(logits, labels), aux,
                              aux_weight, z_loss)


def loss_fn(params: Dict, batch: Dict, cfg: ArchConfig, *, window: int = 0,
            attn_chunk: int = 512, remat: bool = True,
            compute_dtype: torch.dtype = torch.bfloat16,
            use_kernel: Optional[bool] = None) -> Tuple[torch.Tensor, Dict]:
    """:func:`forward` on ``batch["tokens"]`` (after
    ``batch["extra_embeds"]``, if given) then :func:`lm_loss` against
    ``batch["labels"]``, the frontend positions labelled -1 (no loss),
    with the MoE aux loss at ``router_aux_weight``.  The reference always
    computes in bfloat16 here; ``compute_dtype`` lets a float32 run
    compare against its float32 forward.  The one-position case of
    :func:`tp_loss_fn`."""
    return parts_loss([loss_parts(params, batch, cfg, window=window,
                                  attn_chunk=attn_chunk, remat=remat,
                                  compute_dtype=compute_dtype,
                                  use_kernel=use_kernel)],
                      cfg, batch["tokens"].device)


def loss_parts(params: Dict, batch: Dict, cfg: ArchConfig, **kw
               ) -> Tuple[Dict[str, torch.Tensor], List[Tuple]]:
    """One position's share of :func:`loss_fn` over its rows ``batch``:
    (:func:`lm_loss_parts`, the MoE layers' balance means), which
    :func:`parts_loss` adds over positions before dividing.  ``kw`` as
    :func:`loss_fn`'s."""
    plan = tp_plan(cfg, None, [batch["tokens"].device])
    return slice_parts([params], batch, cfg, plan, **kw)


def parts_loss(parts: List[Tuple[Dict[str, torch.Tensor], List[Tuple]]],
               cfg: ArchConfig, dst: torch.device
               ) -> Tuple[torch.Tensor, Dict]:
    """The loss of data-parallel shares, each (:func:`lm_loss_parts`, the
    MoE layers' balance means or []): the sums added on ``dst`` before
    dividing (a mean of the shares' losses is wrong where the label masks
    fall unevenly), and the MoE aux from the shares' averaged balance
    means (:func:`_balance_aux`).  Returns the loss and the metrics of
    :func:`lm_loss`."""
    totals: Dict[str, torch.Tensor] = {}
    for share, _ in parts:
        for k, v in share.items():
            totals[k] = v.to(dst) if k not in totals else totals[k] + v.to(dst)
    aw = cfg.moe.router_aux_weight if cfg.moe else 0.0
    return lm_loss_from_parts(
        totals, _balance_aux([m for _, m in parts], cfg, dst), aw)


# ---------------------------------------------------------------------------
# int8 paged-pool quantization
# ---------------------------------------------------------------------------
def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization of K/V vectors with one scale per
    (token, kv-head), ``amax(|x|, axis=-1) / 127``, as the reference."""
    xf = x.to(torch.float32)
    amax = torch.amax(torch.abs(xf), dim=-1)
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127.0, 127.0)
    return q.to(torch.int8), scale


def _write_kv_pool(cache_l: Dict, k: torch.Tensor, v: torch.Tensor,
                   blk: torch.Tensor, off: torch.Tensor) -> None:
    """Scatter K/V (T, Hkv, D) into one layer's pools at ``(blk, off)``, in
    place.  int8 pools (marked by ``k_scale``) quantize on write and
    scatter the scales through the same indices.  Padding tokens all
    target slot 0 of the null block, which nothing reads, so their
    duplicate indices are harmless."""
    if "k_scale" in cache_l:
        qk, ks = _quantize_kv(k)
        qv, vs = _quantize_kv(v)
        cache_l["k"][blk, off] = qk
        cache_l["v"][blk, off] = qv
        cache_l["k_scale"][blk, off] = ks
        cache_l["v_scale"][blk, off] = vs
        return
    cache_l["k"][blk, off] = k.to(cache_l["k"].dtype)
    cache_l["v"][blk, off] = v.to(cache_l["v"].dtype)


def _pool_scales(cache_l: Dict) -> Dict:
    if "k_scale" in cache_l:
        return {"k_scale": cache_l["k_scale"], "v_scale": cache_l["v_scale"]}
    return {}


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------
def _kv_heads(k: torch.Tensor, v: torch.Tensor, cache_l: Dict,
              kv: Optional[Tuple[int, int]]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K/V cut to the kv heads ``kv = (k0, k1)`` that a tensor-parallel
    shard's pool holds, where the shard computed more of them (its wk/wv
    replicated); unchanged otherwise."""
    if kv is None or k.shape[-2] == cache_l["k"].shape[-2]:
        return k, v
    return k[..., kv[0]:kv[1], :], v[..., kv[0]:kv[1], :]


def _attn_paged(bp: Dict, xn: torch.Tensor, cache_l: Dict,
                block_tables: torch.Tensor, pos: torch.Tensor,
                q_lens: torch.Tensor, cfg: ArchConfig, *, window: int,
                use_kernel: Optional[bool] = None,
                kv: Optional[Tuple[int, int]] = None,
                bias: bool = True) -> torch.Tensor:
    """The attention of one layer over a chunk of C tokens per lane, xn
    (B, C, d) normed: QKV (RoPE at ``pos[b] + c``) -> K/V written through
    ``block_tables`` -> the rectangular paged attention read -> out
    projection (``bias=False``: without ``bo``).  Writes past a lane's
    ``q_lens`` land on slot 0 of the reserved null block, which nothing
    reads, so padded and paused lanes are harmless."""
    from repro_torch.kernels import ops as kernel_ops
    C = xn.shape[1]
    bs = cache_l["k"].shape[1]
    max_blocks = block_tables.shape[1]
    offs = torch.arange(C, device=xn.device)
    positions = pos[:, None] + offs[None, :]                  # (B, C)
    q, k, v = layers.project_qkv(bp["attn"], xn, positions, cfg)
    k, v = _kv_heads(k, v, cache_l, kv)
    valid = offs[None, :] < q_lens[:, None]
    lblk = torch.clamp(positions.long() // bs, max=max_blocks - 1)
    blk = torch.where(valid, torch.gather(block_tables.long(), 1, lblk), 0)
    off = torch.where(valid, positions.long() % bs, 0)
    _write_kv_pool(cache_l, k, v, blk, off)
    attn = kernel_ops.paged_attention_chunk(
        q, cache_l["k"], cache_l["v"], block_tables, pos, q_lens,
        window=window, use_kernel=use_kernel, **_pool_scales(cache_l))
    return layers.project_out(bp["attn"], attn, cfg, bias=bias)


def _attn_ragged(bp: Dict, xn: torch.Tensor, cache_l: Dict,
                 token_tables: Optional[torch.Tensor],
                 token_pos: torch.Tensor, slot_mapping: torch.Tensor,
                 tile_spec, cfg: ArchConfig, *, window: int,
                 use_kernel: Optional[bool] = None,
                 kv: Optional[Tuple[int, int]] = None,
                 bias: bool = True) -> torch.Tensor:
    """The attention of one layer over the flat stream, xn (T, d) normed:
    QKV (RoPE at ``token_pos``) -> K/V scattered to ``slot_mapping`` ->
    the paged attention read -> out projection (``bias=False``: without
    ``bo``).  The read is segment-tiled with ``tile_spec``
    (block_tables, tile_meta, row_tile, tile), else per token through
    ``token_tables`` (T, max_blocks)."""
    from repro_torch.kernels import ops as kernel_ops
    bs = cache_l["k"].shape[1]
    q, k, v = layers.project_qkv(bp["attn"], xn, token_pos, cfg)
    k, v = _kv_heads(k, v, cache_l, kv)
    slots = slot_mapping.long()
    _write_kv_pool(cache_l, k, v, slots // bs, slots % bs)
    if tile_spec is not None:
        tables, tile_meta, row_tile, tile = tile_spec
        attn = kernel_ops.paged_attention_ragged_tiled(
            q, cache_l["k"], cache_l["v"], tables, tile_meta, row_tile,
            tile=tile, window=window, use_kernel=use_kernel,
            **_pool_scales(cache_l))
    else:
        attn = kernel_ops.paged_attention_ragged(
            q, cache_l["k"], cache_l["v"], token_tables, token_pos,
            window=window, use_kernel=use_kernel, **_pool_scales(cache_l))
    return layers.project_out(bp["attn"], attn, cfg, bias=bias)


def _apply_block_decode(bp: Dict, x: torch.Tensor, cache_l: Dict,
                        slot_positions: torch.Tensor, pos: torch.Tensor,
                        cfg: ArchConfig, *, window: int) -> torch.Tensor:
    """Decode one token per lane through one block; cache_l {"k","v"}
    (B, S, Hkv, D) views, written in place at slot ``pos % S``."""
    B = x.shape[0]
    xn = apply_norm(cfg.norm_type, bp["attn_norm"], x)
    q, k, v = layers.project_qkv(bp["attn"], xn, pos[:, None], cfg)
    slot = pos.long() % cache_l["k"].shape[1]
    bidx = torch.arange(B, device=x.device)
    cache_l["k"][bidx, slot] = k[:, 0].to(cache_l["k"].dtype)
    cache_l["v"][bidx, slot] = v[:, 0].to(cache_l["v"].dtype)
    attn = layers.decode_attention(q, cache_l["k"], cache_l["v"],
                                   slot_positions, pos, window=window)
    attn = layers.project_out(bp["attn"], attn, cfg)
    return _mlp_residual(bp, x, xn, attn, cfg)[0]


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------
def init_cache(cfg: ArchConfig, batch: int, cache_len: int, *,
               window: int = 0, dtype: torch.dtype = torch.bfloat16,
               device="cuda") -> Dict:
    """Dense per-lane KV cache; with a sliding window a rolling buffer of
    ``min(window, cache_len)`` slots."""
    _check_family(cfg)
    dev = resolve_device(device)
    n_slots = min(window, cache_len) if window else cache_len
    shape = (cfg.n_layers, batch, n_slots, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {
        "scan": {"k": torch.zeros(shape, dtype=dtype, device=dev),
                 "v": torch.zeros(shape, dtype=dtype, device=dev)},
        "slot_positions": -torch.ones((batch, n_slots), dtype=torch.int32,
                                      device=dev),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }


def decode_step(params: Dict, cache: Dict, tokens: torch.Tensor,
                cfg: ArchConfig, *, window: int = 0,
                compute_dtype: Optional[torch.dtype] = None
                ) -> Tuple[torch.Tensor, Dict]:
    """tokens (B, 1) -> (logits (B, 1, V) float32, cache), the cache
    updated in place (``pos`` advances by one for every lane)."""
    _check_compute_dtype(params, compute_dtype)
    B = tokens.shape[0]
    pos = cache["pos"]
    x = _embed(params, tokens, cfg)
    n_slots = cache["scan"]["k"].shape[2]
    bidx = torch.arange(B, device=tokens.device)
    cache["slot_positions"][bidx, pos.long() % n_slots] = pos
    for l, bp in enumerate(_layers(params, cfg)):
        cl = {name: arr[l] for name, arr in cache["scan"].items()}
        x = _apply_block_decode(bp, x, cl, cache["slot_positions"], pos, cfg,
                                window=window)
    cache["pos"] = pos + 1
    return _finish(params, x, cfg), cache


def init_paged_cache(cfg: ArchConfig, n_lanes: int, *, num_blocks: int,
                     block_size: int, max_blocks_per_lane: int,
                     dtype: torch.dtype = torch.bfloat16,
                     device="cuda", n_kv_heads: Optional[int] = None
                     ) -> Dict:
    """Paged KV pools shared by all lanes, one (L, num_blocks, bs, Hkv, D)
    tensor per leaf; block 0 is the engine's reserved null block.
    ``dtype=torch.int8`` stores quantized pools with float32
    ``k_scale``/``v_scale`` pools of shape (L, num_blocks, bs, Hkv).
    ``n_kv_heads`` (default the config's) sizes a tensor-parallel shard's
    pools."""
    _check_family(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, num_blocks, block_size,
             n_kv_heads or cfg.n_kv_heads, cfg.resolved_head_dim)
    pool = {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}
    if not dtype.is_floating_point:
        pool["k_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                      device=dev)
        pool["v_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                      device=dev)
    return {
        "scan": pool,
        "block_tables": torch.zeros((n_lanes, max_blocks_per_lane),
                                    dtype=torch.int32, device=dev),
        "pos": torch.zeros((n_lanes,), dtype=torch.int32, device=dev),
    }


def _check_compute_dtype(params: Dict, compute_dtype) -> None:
    have = params["embed"]["embedding"].dtype
    if compute_dtype is not None and compute_dtype != have:
        raise ValueError(f"parameters are stored in {have}; the port casts "
                         f"weights once, so compute_dtype={compute_dtype} "
                         "needs parameters made in that dtype")


def paged_step(params: Dict, cache: Dict, tokens: torch.Tensor,
               cfg: ArchConfig, *, window: int = 0,
               compute_dtype: Optional[torch.dtype] = None,
               use_kernel: Optional[bool] = None
               ) -> Tuple[torch.Tensor, Dict]:
    """tokens (B, C) -> (logits (B, C, V) float32, cache): the rectangular
    prefill/decode step over the paged pools.  A lane's chunk is a
    prefill slice, a decode token (C = 1), a draft segment or padding.
    ``cache["pos"]`` (B,) is the position of each lane's first chunk token
    (the tokens already in its KV); ``cache["q_lens"]`` (B,), if present,
    the real tokens of each chunk (absent: all C).  The KV pools are
    updated in place and ``pos`` advances by ``q_lens``.  Logits cover
    every chunk row (the speculative-decode verification contract)."""
    logits, _ = tp_paged_step([params], [cache], [tokens], cfg,
                              tp_plan(cfg, None, [tokens.device]),
                              window=window, compute_dtype=compute_dtype,
                              use_kernel=use_kernel)
    return logits, cache


def paged_decode_step(params: Dict, cache: Dict, tokens: torch.Tensor,
                      cfg: ArchConfig, *, window: int = 0,
                      compute_dtype: Optional[torch.dtype] = None
                      ) -> Tuple[torch.Tensor, Dict]:
    """tokens (B, 1) -> (logits (B, 1, V), cache): the q_len = 1 case of
    :func:`paged_step`, for the single-sequence debug path."""
    return paged_step(params, cache, tokens, cfg, window=window,
                      compute_dtype=compute_dtype)


def ragged_step(params: Dict, cache: Dict, tokens: torch.Tensor,
                cfg: ArchConfig, *, window: int = 0, tile: int = 16,
                compute_dtype: Optional[torch.dtype] = None,
                use_kernel: Optional[bool] = None
                ) -> Tuple[torch.Tensor, Dict]:
    """tokens (T,) -> (logits (T, V) float32, cache): the ragged
    flat-token serving step.  The engine writes the per-step metadata
    into the cache first: ``token_pos`` and ``slot_mapping`` (T,),
    ``block_tables`` (n_lanes, max_blocks), and either the TileMap arrays
    ``tile_meta`` (5, n_tiles) and ``row_tile`` (T,), for the
    segment-tiled read, or ``token_lane`` (T,), for the per-token read
    through ``block_tables[token_lane]``.  The KV pools are updated in
    place.  Logits cover every row of the stream (the speculative-decode
    verification contract), so a draft segment yields the model's greedy
    continuation at every draft slot."""
    logits, _ = tp_ragged_step([params], [cache], [tokens], cfg,
                               tp_plan(cfg, None, [tokens.device]),
                               window=window, tile=tile,
                               compute_dtype=compute_dtype,
                               use_kernel=use_kernel)
    return logits, cache


# ---------------------------------------------------------------------------
# Tensor-parallel serving steps (one device: the one-position plan)
# ---------------------------------------------------------------------------
def _cut(spec, tp: int) -> bool:
    """Whether a leaf's PartitionSpec cuts it over "model" (tp > 1)."""
    return tp > 1 and any(s == "model" or (isinstance(s, tuple)
                                           and "model" in s) for s in spec)


@dataclasses.dataclass
class TPPlan:
    """How the tensor-parallel steps run one model over mesh positions.

    ``devices`` are the positions' devices (position s holds shard s of
    every leaf cut over "model"; positions may share a device).  The
    flags say which contractions the specs cut: ``embed`` (the vocab of
    the embedding: a masked lookup, then a reduce), ``head`` (the vocab
    of the logits: gathered), and per layer ``attn`` (heads: a reduce
    after ``wo``), ``mlp`` (d_ff: a reduce after ``w_down``), ``router``
    (the router's expert columns: logits gathered before routing),
    ``experts`` (E: a reduce after the combine) and ``shared`` (the
    shared experts' d_ff).  A sublayer that is not cut runs whole on
    every position and is not reduced.  ``kv[s]`` is the range of kv
    heads position s's pools hold and its attention reads: its own heads
    where wk/wv are cut, else the one kv head its q heads share, else
    all of them.  ``specs`` place the parameters on the positions: the
    serving specs, with the per-head q/k norm scales whole (the steps
    read them whole; the reference's partitioner gathers them at use).
    ``collectives`` counts the reduces and gathers run since the last
    :meth:`reset`: in training, their backward duals too (each is an
    autograd Function), and under per-block remat a layer's forward ones
    again.  ``collective_bytes`` counts beside it the bytes of each
    one's output that a position receives: the whole sum of a reduce,
    the whole of a gather, position 0's piece of a gather's backward (a
    reduce-scatter), as the reference's dry-run sums the per-device
    output shapes of its HLO collectives."""
    devices: List[torch.device]
    embed: bool
    head: bool
    layers: List[Dict[str, bool]]
    kv: List[Tuple[int, int]]
    specs: Dict
    collectives: int = 0
    collective_bytes: int = 0
    # the MoE layers' stage marks (serving/tracing.py's MoEStages) while
    # a traced serving step runs, else None
    stages: Optional[object] = None

    def reset(self) -> None:
        """Set both counts to 0."""
        self.collectives = 0
        self.collective_bytes = 0

    def _count(self, out: Optional[torch.Tensor]) -> None:
        """One collective whose output a position receives is ``out``."""
        self.collectives += 1
        if out is not None:
            self.collective_bytes += out.numel() * out.element_size()

    @property
    def tp(self) -> int:
        return len(self.devices)

    def reduce(self, parts: List[torch.Tensor]) -> List[torch.Tensor]:
        """Sum the positions' partial tensors in position order on
        position 0's device and hand every position the sum (on a shared
        device, the same tensor), so all positions see the same bits.
        Its backward is a reduce too: every part's gradient is the sum of
        the positions' output gradients."""
        return list(_Reduce.apply(self, *parts))

    def gather(self, parts: List[torch.Tensor]) -> List[torch.Tensor]:
        """Concatenate the positions' pieces along the last dim on
        position 0's device and hand every position the whole.  Its
        backward sums the positions' output gradients and splits the sum
        (a reduce-scatter)."""
        return list(_Gather.apply(self, *parts))


def _sum_on(dst: torch.device, grads) -> Optional[torch.Tensor]:
    """The sum of the gradients that are not None, in position order on
    ``dst`` (None if every one is)."""
    total = None
    for g in grads:
        if g is not None:
            total = g.to(dst) if total is None else total + g.to(dst)
    return total


class _Reduce(torch.autograd.Function):
    """:meth:`TPPlan.reduce` with its backward, each counted."""

    @staticmethod
    def forward(ctx, plan: TPPlan, *parts: torch.Tensor):
        ctx.set_materialize_grads(False)
        ctx.plan = plan
        ctx.part_devices = [p.device for p in parts]
        dst = plan.devices[0]
        total = parts[0].to(dst)
        for p in parts[1:]:
            total = total + p.to(dst)
        plan._count(total)
        return tuple(total.to(d) for d in plan.devices)

    @staticmethod
    def backward(ctx, *grads):
        plan = ctx.plan
        total = _sum_on(plan.devices[0], grads)
        plan._count(total)
        return (None,) + tuple(None if total is None else total.to(d)
                               for d in ctx.part_devices)


class _Gather(torch.autograd.Function):
    """:meth:`TPPlan.gather` with its backward, each counted."""

    @staticmethod
    def forward(ctx, plan: TPPlan, *parts: torch.Tensor):
        ctx.set_materialize_grads(False)
        ctx.plan = plan
        ctx.part_devices = [p.device for p in parts]
        ctx.widths = [p.shape[-1] for p in parts]
        dst = plan.devices[0]
        whole = torch.cat([p.to(dst) for p in parts], dim=-1)
        plan._count(whole)
        return tuple(whole.to(d) for d in plan.devices)

    @staticmethod
    def backward(ctx, *grads):
        plan = ctx.plan
        total = _sum_on(plan.devices[0], grads)
        if total is None:
            plan._count(None)
            return (None,) * (1 + len(ctx.widths))
        pieces = total.split(ctx.widths, dim=-1)
        plan._count(pieces[0])
        return (None,) + tuple(g.to(d) for g, d in zip(
            pieces, ctx.part_devices))


def tp_specs(specs: Dict) -> Dict:
    """Parameter specs as the tensor-parallel steps read them: the
    per-head q/k norm scales whole (the steps read them whole; the
    reference's partitioner gathers them at use)."""
    def whole_norms(b: Dict) -> Dict:
        attn = {k: (None,) * len(v) if k.endswith("norm_scale") else v
                for k, v in b["attn"].items()}
        return {**b, "attn": attn}

    specs = {**specs, "blocks": whole_norms(specs["blocks"])}
    if "head_blocks" in specs:
        specs["head_blocks"] = [whole_norms(b) for b in specs["head_blocks"]]
    return specs


def tp_plan(cfg: ArchConfig, specs: Optional[Dict], devices) -> TPPlan:
    """The :class:`TPPlan` of parameters cut by ``specs`` (the
    ``serving_param_specs`` of the parameter tree) over ``devices``;
    ``specs=None``: nothing cut (one position holds the whole model, as
    :func:`ragged_step` and :func:`paged_step` run it).  Raises where a
    position's q heads would straddle two kv groups."""
    _check_family(cfg)
    devices = list(devices)
    tp = len(devices)
    if specs is None:
        whole = dict.fromkeys(("attn", "mlp", "router", "experts",
                               "shared"), False)
        return TPPlan(devices=devices, embed=False, head=False,
                      layers=[whole] * cfg.n_layers,
                      kv=[(0, cfg.n_kv_heads)] * tp, specs=None)

    specs = tp_specs(specs)

    def layer(b: Dict) -> Dict[str, bool]:
        out = {"attn": _cut(b["attn"]["wo"], tp)}
        if "moe" in b:
            m = b["moe"]
            out.update(router=_cut(m["router"], tp),
                       experts=_cut(m["experts_w_down"], tp))
            if "shared" in m:
                out["shared"] = _cut(m["shared"]["w_down"], tp)
        else:
            out["mlp"] = _cut(b["mlp"]["w_down"], tp)
        return out

    head_blocks = specs.get("head_blocks", [])
    plan_layers = [layer(b) for b in head_blocks] + \
        [layer(specs["blocks"])] * (cfg.n_layers - len(head_blocks))
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    attn = specs["blocks"]["attn"]
    if _cut(attn["wk"], tp):
        n = Hkv // tp
        kv = [(s * n, (s + 1) * n) for s in range(tp)]
    elif _cut(attn["wq"], tp):
        hs, group = H // tp, H // Hkv
        if group % hs:
            raise ValueError(
                f"{cfg.name}: a position's {hs} q heads straddle kv "
                f"groups of {group} heads at tp {tp}")
        kv = [(s * hs // group, s * hs // group + 1) for s in range(tp)]
    else:
        kv = [(0, Hkv)] * tp
    head = specs["embed"]["embedding"] if cfg.tie_embeddings \
        else specs["head"]["w"]
    return TPPlan(devices=devices, embed=_cut(specs["embed"]["embedding"], tp),
                  head=_cut(head, tp), layers=plan_layers, kv=kv,
                  specs=specs)


def _tp_embed(shards: List[Dict], tokens: List[torch.Tensor],
              cfg: ArchConfig, plan: TPPlan) -> List[torch.Tensor]:
    """Each position's embedded tokens: with a vocab-cut embedding, a
    lookup masked to the position's rows, then a reduce (every token's
    row lives on one position, so the sum is exact)."""
    if plan.embed:
        parts = []
        for s, (p, t) in enumerate(zip(shards, tokens)):
            table = p["embed"]["embedding"]
            rows = table.shape[0]
            local = t.long() - s * rows
            inside = (local >= 0) & (local < rows)
            parts.append(table[local.clamp(0, rows - 1)]
                         * inside[..., None].to(table.dtype))
        xs = plan.reduce(parts)
    else:
        xs = [layers.embed_tokens(p["embed"], t.long())
              for p, t in zip(shards, tokens)]
    if cfg.scale_embeddings:
        xs = [x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                               device=x.device) for x in xs]
    return xs


def _tp_sum(plan: TPPlan, outs) -> List[torch.Tensor]:
    """The sum of sublayer outputs ``outs``, each (per-position tensors,
    cut, per-position bias or None): the cut ones' partial sums added per
    position and reduced once, their biases added after the reduce, the
    whole ones added per position."""
    ys = None
    cut = [o for o, c, _ in outs if c]
    if cut:
        ys = plan.reduce([functools.reduce(torch.add, [o[s] for o in cut])
                          for s in range(plan.tp)])
    for o, c, bias in outs:
        if not c:
            ys = list(o) if ys is None else [y + w for y, w in zip(ys, o)]
        elif bias is not None:
            ys = [y + b for y, b in zip(ys, bias)]
    return ys


def _tp_ffn(bps, xms, cfg: ArchConfig, plan: TPPlan, lp: Dict[str, bool]):
    """The MLP or MoE sublayer on every position: (``_tp_sum``'s outputs,
    the MoE layer's ``moe.balance_means`` or None).  The MoE gathers cut
    router logits first, so every position routes (and drops) as one
    device would, and the balance means come from position 0 alone (the
    aux counts once); its capacity groups are x's leading axis, the flat
    stream one group."""
    bias = cfg.use_bias
    if "moe" not in bps[0]:
        c = lp["mlp"]
        return [([layers.apply_mlp(bp["mlp"], x, cfg, bias=not c)
                  for bp, x in zip(bps, xms)], c,
                 [bp["mlp"]["b_down"] for bp in bps] if c and bias
                 else None)], None
    flat = xms[0].dim() == 2
    xg = [x[None] if flat else x for x in xms]
    logits = [moe_lib.router_logits(bp["moe"], x) for bp, x in zip(bps, xg)]
    if lp["router"]:
        logits = plan.gather(logits)
    routed = []
    for s, (bp, x, lg) in enumerate(zip(bps, xg, logits)):
        n = bp["moe"]["experts_w_down"].shape[0]
        y, m = moe_lib.routed_experts(bp["moe"], x, cfg, lg,
                                      e0=s * n if lp["experts"] else 0,
                                      stages=plan.stages)
        routed.append(y[0] if flat else y)
        if s == 0:
            means = m
    outs = [(routed, lp["experts"], None)]
    if "shared" in bps[0]["moe"]:
        c = lp["shared"]
        outs.append(([layers.apply_mlp(bp["moe"]["shared"], x, cfg,
                                       bias=not c)
                      for bp, x in zip(bps, xms)], c,
                     [bp["moe"]["shared"]["b_down"] for bp in bps]
                     if c and bias else None))
    return outs, means


def _tp_layer(bps, xs: List[torch.Tensor], attn_fn, cfg: ArchConfig,
              plan: TPPlan, lp: Dict[str, bool]
              ) -> Tuple[List[torch.Tensor], Optional[Tuple]]:
    """One layer on every position: (the positions' outputs, the MoE
    layer's balance means or None).  ``attn_fn(s, xn, bias)`` is position
    s's attention output.  A parallel block whose attention is cut takes
    one reduce for its attention and MLP together; otherwise the
    attention's residual add comes first, then the MLP's (the order of
    :func:`_mlp_residual`, so the one-position plan computes the single
    device's layer), each reduced where it is cut."""
    xns = [apply_norm(cfg.norm_type, bp["attn_norm"], x)
           for bp, x in zip(bps, xs)]
    c = lp["attn"]
    attn = ([attn_fn(s, xn, not c) for s, xn in enumerate(xns)], c,
            [bp["attn"]["bo"] for bp in bps] if c and cfg.use_bias
            else None)
    if cfg.parallel_block and c:
        ffn, means = _tp_ffn(bps, xns, cfg, plan, lp)
        ys = _tp_sum(plan, [attn] + ffn)
        return [x + y for x, y in zip(xs, ys)], means
    xs = [x + y for x, y in zip(xs, _tp_sum(plan, [attn]))]
    xms = xns if cfg.parallel_block else [
        apply_norm(cfg.norm_type, bp["mlp_norm"], x)
        for bp, x in zip(bps, xs)]
    ffn, means = _tp_ffn(bps, xms, cfg, plan, lp)
    ys = _tp_sum(plan, ffn)
    return [x + y for x, y in zip(xs, ys)], means


def _tp_finish(shards: List[Dict], xs: List[torch.Tensor], cfg: ArchConfig,
               plan: TPPlan) -> torch.Tensor:
    """Logits on position 0's device: vocab-cut logits gathered."""
    if not plan.head:
        return _finish(shards[0], xs[0], cfg)
    parts = [layers.lm_logits(p.get("head"), p["embed"],
                              apply_norm(cfg.norm_type, p["final_norm"], x),
                              cfg.tie_embeddings)
             for p, x in zip(shards, xs)]
    return plan.gather(parts)[0]


def _tp_attention(bps, positions, cfg: ArchConfig, plan: TPPlan, *,
                  window: int, attn_chunk: int,
                  use_kernel: Optional[bool]):
    """``_tp_layer``'s attention for the training forward: position s
    projects its q heads, reads the kv heads ``plan.kv[s]`` (cut from the
    whole set where its wk/wv are replicated), runs
    ``layers.causal_attention`` at its shard's head count (on CUDA
    tensors the flash kernels, forward and backward) and projects out."""
    def attn(s, xn, bias):
        p = bps[s]["attn"]
        q, k, v = layers.project_qkv(p, xn, positions[s], cfg)
        k0, k1 = plan.kv[s]
        if k.shape[-2] != k1 - k0:
            k, v = k[..., k0:k1, :], v[..., k0:k1, :]
        o = layers.causal_attention(q, k, v, window=window,
                                    chunk=attn_chunk, use_kernel=use_kernel)
        return layers.project_out(p, o, cfg, bias=bias)

    return attn


class _Remat(torch.autograd.Function):
    """:func:`remat_node`'s node: the inputs are the flat tensors, ``run``
    maps them to the flat outputs."""

    @staticmethod
    def forward(ctx, run, *inputs: torch.Tensor):
        ctx.set_materialize_grads(False)
        ctx.run = run
        ctx.save_for_backward(*inputs)
        # grad mode on over detached inputs, so every op runs as it does
        # when autograd records (the flash kernels' B6f, not B6); the
        # graph it builds is dropped with ``outs``
        with torch.enable_grad():
            outs = run(*_detached(inputs))
        return tuple(o.detach() for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        inputs = _detached(ctx.saved_tensors)
        with torch.enable_grad():
            outs = ctx.run(*inputs)
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        need = [x for x in inputs if x.requires_grad]
        got = iter(torch.autograd.grad(
            [o for o, _ in pairs], need, [g for _, g in pairs],
            allow_unused=True) if pairs and need else [None] * len(need))
        return (None,) + tuple(next(got) if x.requires_grad else None
                               for x in inputs)


def _detached(ts) -> List[torch.Tensor]:
    return [t.detach().requires_grad_(t.requires_grad) for t in ts]


def remat_node(fn, *args):
    """``fn(*args)`` as one autograd node that keeps only its inputs and
    recomputes ``fn`` once in the backward, whichever device thread of
    the backward reaches it (reentrant style: the node's inputs are every
    tensor of ``args``, weights and activations, and its backward
    differentiates the recomputation).  ``args`` and the result are
    nested lists, tuples and dicts of tensors (and None); every reduce
    and gather of ``fn`` runs again in the recomputation, and every
    kernel runs as under autograd both times."""
    leaves, (rebuild,) = _flatten(args)
    out_rebuild = []

    def run(*flat):
        out, out_rebuild[:] = _flatten(fn(*rebuild(flat)))
        return out

    outs = _Remat.apply(run, *leaves)       # sets out_rebuild
    return out_rebuild[0](outs)


def _flatten(tree):
    """(the tensors of a nested list / tuple / dict / None tree, in order,
    and a one-element list holding the function that rebuilds the tree
    from such a sequence)."""
    if torch.is_tensor(tree):
        return [tree], [lambda flat: flat[0]]
    if tree is None:
        return [], [lambda flat: None]
    keys = list(tree) if isinstance(tree, dict) else range(len(tree))
    parts = [_flatten(tree[k]) for k in keys]

    def rebuild(flat):
        out, i = [], 0
        for leaves, (fn,) in parts:
            out.append(fn(flat[i:i + len(leaves)]))
            i += len(leaves)
        return dict(zip(keys, out)) if isinstance(tree, dict) \
            else type(tree)(out)

    return [t for leaves, _ in parts for t in leaves], [rebuild]


def tp_forward(shards: List[Dict], tokens: List[torch.Tensor],
               cfg: ArchConfig, plan: TPPlan, *, window: int = 0,
               extra_embeds: Optional[List[torch.Tensor]] = None,
               compute_dtype: torch.dtype = torch.bfloat16,
               attn_chunk: int = 512, remat: bool = True,
               use_kernel: Optional[bool] = None
               ) -> Tuple[torch.Tensor, List[Tuple]]:
    """:func:`forward` over the mesh positions of ``plan``: position s
    runs its local parameters ``shards[s]`` (cast to ``compute_dtype``
    once) on its copy ``tokens[s]`` (B, S) of the batch (after its
    ``extra_embeds[s]``), and the layers' partial sums meet in
    ``plan``'s reduces, whose backward duals carry the gradients.  With
    ``remat`` each layer over all positions is one :func:`remat_node` node
    when autograd records, recomputed once in the backward (on one device
    or several), so its recomputation repeats every forward collective of
    the layer.  Returns (logits (B, S_extra + S, V) float32 on position
    0's device, the MoE layers' ``moe.balance_means`` in order, from
    position 0)."""
    _check_family(cfg)
    ps = [cast_weights(p, compute_dtype) for p in shards]
    xs = _tp_embed(ps, tokens, cfg, plan)
    if extra_embeds is not None:
        xs = [torch.cat([e.to(compute_dtype), x], dim=1)
              for e, x in zip(extra_embeds, xs)]
    positions = [torch.arange(x.shape[1], device=x.device) for x in xs]

    def block(l, bps, xs_):
        attn = _tp_attention(bps, positions, cfg, plan, window=window,
                             attn_chunk=attn_chunk, use_kernel=use_kernel)
        return _tp_layer(bps, xs_, attn, cfg, plan, plan.layers[l])

    means = []
    for l, bps in enumerate(zip(*(_layers(p, cfg) for p in ps))):
        run = functools.partial(block, l)
        if remat and torch.is_grad_enabled():
            xs, m = remat_node(run, list(bps), xs)
        else:
            xs, m = run(list(bps), xs)
        if m is not None:
            means.append(m)
    return _tp_finish(ps, xs, cfg, plan), means


def _balance_aux(means: List[List[Tuple]], cfg: ArchConfig,
                 dst: torch.device) -> torch.Tensor:
    """The MoE aux loss of data-parallel slices' balance means (one list
    of per-layer means a slice): each layer's two per-expert means
    averaged over the slices on ``dst`` (equal token counts a slice) before
    their product, as the reference's global-batch aux; the layers'
    losses summed (0 for the dense family)."""
    aux = torch.zeros((), dtype=torch.float32, device=dst)
    for per_slice in zip(*means):
        n = len(per_slice)
        me = sum(m[0].to(dst) for m in per_slice) / n
        ce = sum(m[1].to(dst) for m in per_slice) / n
        aux = aux + moe_lib.balance_loss((me, ce), cfg.moe.n_experts)
    return aux


def slice_parts(shards: List[Dict], batch: Dict, cfg: ArchConfig,
                plan: TPPlan, *, window: int = 0, attn_chunk: int = 512,
                remat: bool = True,
                compute_dtype: torch.dtype = torch.bfloat16,
                use_kernel: Optional[bool] = None
                ) -> Tuple[Dict[str, torch.Tensor], List[Tuple]]:
    """One tensor-parallel slice's share of the loss: :func:`tp_forward`
    of its positions' local parameters ``shards`` under ``plan`` over its
    rows ``batch``, then (:func:`lm_loss_parts` on position 0's device,
    the balance means).  ``batch["extra_embeds"]``, if given, is one
    (B, S_extra, d_model) tensor copied to every position or a list of
    the positions' own (a tensor-parallel projector's outputs); its
    positions are labelled -1 (no loss)."""
    extra = batch.get("extra_embeds")
    if torch.is_tensor(extra):
        extra = [extra.to(d) for d in plan.devices]
    logits, means = tp_forward(
        shards, [batch["tokens"].to(d) for d in plan.devices], cfg, plan,
        window=window, extra_embeds=extra, compute_dtype=compute_dtype,
        attn_chunk=attn_chunk, remat=remat, use_kernel=use_kernel)
    labels = batch["labels"].to(logits.device)
    if extra is not None:
        pad = -torch.ones(extra[0].shape[:2], dtype=labels.dtype,
                          device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    return lm_loss_parts(logits, labels), means


def tp_loss_fn(slices: List[List[Dict]], batches: List[Dict],
               cfg: ArchConfig, plans: List[TPPlan], **kw
               ) -> Tuple[torch.Tensor, Dict]:
    """:func:`loss_fn` over data-parallel slices, each tensor-parallel:
    slice i's share (:func:`slice_parts`) from its positions' local
    parameters ``slices[i]`` under ``plans[i]`` over its rows
    ``batches[i]``, the shares added on slice 0's first device by
    :func:`parts_loss`.  ``kw`` as :func:`slice_parts`'.  Returns the
    loss and the metrics of :func:`lm_loss`."""
    return parts_loss([slice_parts(shards, batch, cfg, plan, **kw)
                       for shards, batch, plan in zip(slices, batches,
                                                      plans)],
                      cfg, plans[0].devices[0])


def tp_ragged_step(shards: List[Dict], caches: List[Dict],
                   tokens: List[torch.Tensor], cfg: ArchConfig,
                   plan: TPPlan, *, window: int = 0, tile: int = 16,
                   compute_dtype: Optional[torch.dtype] = None,
                   use_kernel: Optional[bool] = None
                   ) -> Tuple[torch.Tensor, List[Dict]]:
    """:func:`ragged_step` over the mesh positions of ``plan`` (the
    layer loop of both; one position is the single device): position
    s runs its shard ``shards[s]`` of the parameters, its own pools and
    metadata ``caches[s]`` (as ``ragged_step`` reads them) and its copy
    ``tokens[s]`` of the stream, at its sharded shapes, and the layers'
    partial sums meet in ``plan``'s reduces.  Returns (logits (T, V)
    float32 on position 0's device, caches)."""
    _check_compute_dtype(shards[0], compute_dtype)
    reads = []
    for c in caches:
        if "tile_meta" in c:
            reads.append((None, (c["block_tables"], c["tile_meta"],
                                 c["row_tile"], tile)))
        else:
            reads.append((c["block_tables"][c["token_lane"].long()], None))
    xs = _tp_embed(shards, tokens, cfg, plan)
    for l, bps in enumerate(zip(*(_layers(p, cfg) for p in shards))):
        def attn(s, xn, bias, _l=l, _bps=bps):
            c = caches[s]
            cl = {name: arr[_l] for name, arr in c["scan"].items()}
            return _attn_ragged(_bps[s], xn, cl, reads[s][0], c["token_pos"],
                                c["slot_mapping"], reads[s][1], cfg,
                                window=window, use_kernel=use_kernel,
                                kv=plan.kv[s], bias=bias)
        xs, _ = _tp_layer(bps, xs, attn, cfg, plan, plan.layers[l])
    return _tp_finish(shards, xs, cfg, plan), caches


def tp_paged_step(shards: List[Dict], caches: List[Dict],
                  tokens: List[torch.Tensor], cfg: ArchConfig,
                  plan: TPPlan, *, window: int = 0,
                  compute_dtype: Optional[torch.dtype] = None,
                  use_kernel: Optional[bool] = None
                  ) -> Tuple[torch.Tensor, List[Dict]]:
    """:func:`paged_step` over the mesh positions of ``plan``, as
    :func:`tp_ragged_step` runs ``ragged_step``.  Returns (logits
    (B, C, V) float32 on position 0's device, caches)."""
    _check_compute_dtype(shards[0], compute_dtype)
    B, C = tokens[0].shape
    lanes = []
    for c in caches:
        q_lens = c.get("q_lens")
        if q_lens is None:
            q_lens = torch.full((B,), C, dtype=torch.int32,
                                device=c["pos"].device)
        lanes.append((c["pos"], q_lens))
    xs = _tp_embed(shards, tokens, cfg, plan)
    for l, bps in enumerate(zip(*(_layers(p, cfg) for p in shards))):
        def attn(s, xn, bias, _l=l, _bps=bps):
            c = caches[s]
            cl = {name: arr[_l] for name, arr in c["scan"].items()}
            return _attn_paged(_bps[s], xn, cl, c["block_tables"],
                               *lanes[s], cfg, window=window,
                               use_kernel=use_kernel, kv=plan.kv[s],
                               bias=bias)
        xs, _ = _tp_layer(bps, xs, attn, cfg, plan, plan.layers[l])
    for c, (pos, q_lens) in zip(caches, lanes):
        c["pos"] = pos + q_lens
    return _tp_finish(shards, xs, cfg, plan), caches
