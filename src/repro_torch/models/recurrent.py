"""Recurrent-family LMs: zamba2 (Mamba2 + shared attention) and xLSTM.

The counterpart of ``repro/models/recurrent.py``.  Both keep the
reference's stacked segment layout:
  * zamba2: ``segments`` leaves (n_seg, per, ...): n_seg segments of
    ``per`` Mamba2 layers, each segment followed by ONE shared-weight
    attention + MLP block (``shared``, tied across its applications);
  * xLSTM: ``mlstm`` leaves (n_seg, per - 1, ...) and ``slstm`` leaves
    (n_seg, ...): segments of mLSTM blocks closed by one sLSTM block
    (xLSTM[7:1]).
Python loops over segments and layers take the place of ``lax.scan`` (and
``torch.utils.checkpoint`` per segment that of ``jax.checkpoint``).

Decode carries per-layer recurrent state (SSM state, mLSTM matrix memory,
sLSTM scalar state) plus, for zamba2, one KV cache per shared-attention
application; the cache is updated in place.  A state whose dtype a step
promotes (the bfloat16 conv states of a float32 step, as in the reference)
is widened once, whole.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device, seeded_generator
from repro_torch.models import layers, ssm as ssm_lib, xlstm as xlstm_lib
from repro_torch.models.common import (apply_norm, cast_weights, dense_init_,
                                       embed_init_, fan_in_std, norm_params)
from repro_torch.models.transformer import (_check_compute_dtype,
                                            attention_params, mlp_params)


def _index(tree: Dict, *idx) -> Dict:
    """Views of every leaf at the leading index ``idx``."""
    return {k: _index(v, *idx) if isinstance(v, dict) else v[idx]
            for k, v in tree.items()}


def _lead(tree: Dict, shape: Tuple[int, ...]) -> Dict:
    """Every leaf's leading axis split into ``shape``."""
    return {k: _lead(v, shape) if isinstance(v, dict)
            else v.reshape(shape + tuple(v.shape[1:]))
            for k, v in tree.items()}


def _store(tree: Dict, idx: Tuple[int, ...], new: Dict) -> None:
    """Write the state ``new`` into the stacked ``tree`` at ``idx``, in
    place; a stacked leaf narrower than its new value is widened first."""
    for k, v in new.items():
        if tree[k].dtype != v.dtype:
            tree[k] = tree[k].to(torch.promote_types(tree[k].dtype, v.dtype))
        tree[k][idx] = v


def _embed_and_head(cfg: ArchConfig, g: torch.Generator, *, device,
                    dtype: torch.dtype) -> Dict:
    """The untied embedding and LM head and the final norm (with bias for
    layernorm, as the reference's ``norm_params`` default)."""
    d, V = cfg.d_model, cfg.vocab_size
    final = norm_params(cfg.norm_type, d, True, n=1, device=device)
    emb = embed_init_(torch.empty((V, d), dtype=dtype, device=device), g)
    head = dense_init_(torch.empty((d, V), dtype=dtype, device=device), g,
                       std=fan_in_std((d,)))
    return {"embed": {"embedding": emb},
            "final_norm": {k: v[0] for k, v in final.items()},
            "head": {"w": head}}


def _finish(p: Dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    x = apply_norm(cfg.norm_type, p["final_norm"], x)
    return layers.lm_logits(p["head"], p["embed"], x, False)


def _run_segments(n_seg: int, segment, x: torch.Tensor, remat: bool
                  ) -> torch.Tensor:
    """``x = segment(s, x)`` for every segment, each under non-reentrant
    ``torch.utils.checkpoint`` with ``remat`` when autograd records."""
    for s in range(n_seg):
        if remat and torch.is_grad_enabled():
            x = checkpoint(segment, s, x, use_reentrant=False)
        else:
            x = segment(s, x)
    return x


# ===========================================================================
# zamba2-style hybrid
# ===========================================================================
def zamba_segments(cfg: ArchConfig) -> Tuple[int, int]:
    per = cfg.hybrid_attn_every
    assert per and cfg.n_layers % per == 0
    return cfg.n_layers // per, per


def init_zamba_params(cfg: ArchConfig, *, seed: int = 0, device="cuda",
                      dtype: torch.dtype = torch.bfloat16) -> Dict:
    """Random parameters with the reference's shapes and distributions,
    from a ``torch.Generator`` seeded with ``seed`` on ``device``; weights
    in ``dtype``, norms and ``A_log``/``dt_bias`` float32."""
    dev = resolve_device(device)
    g = seeded_generator(dev, seed)
    n_seg, per = zamba_segments(cfg)
    d = cfg.d_model
    kw = dict(device=dev, dtype=dtype)
    p = _embed_and_head(cfg, g, **kw)
    one = lambda t: {k: v[0] for k, v in t.items()}
    # ONE shared attention + MLP block (weights tied across applications)
    p["shared"] = {
        "attn_norm": one(norm_params(cfg.norm_type, d, True, n=1,
                                     device=dev)),
        "attn": one(attention_params(cfg, 1, g, **kw)),
        "mlp_norm": one(norm_params(cfg.norm_type, d, True, n=1,
                                    device=dev)),
        "mlp": one(mlp_params(cfg, 1, g, **kw)),
    }
    n = n_seg * per
    p["segments"] = _lead({
        "norm": norm_params(cfg.norm_type, d, True, n=n, device=dev),
        "mamba": ssm_lib.mamba2_params(cfg, n, g, **kw),
    }, (n_seg, per))
    return p


def _shared_attn_apply(sp: Dict, x: torch.Tensor, positions: torch.Tensor,
                       cfg: ArchConfig, *, window: int, attn_chunk: int = 512,
                       use_kernel: Optional[bool] = None) -> torch.Tensor:
    xn = apply_norm(cfg.norm_type, sp["attn_norm"], x)
    q, k, v = layers.project_qkv(sp["attn"], xn, positions, cfg)
    a = layers.causal_attention(q, k, v, window=window, chunk=attn_chunk,
                                use_kernel=use_kernel)
    x = x + layers.project_out(sp["attn"], a, cfg)
    xm = apply_norm(cfg.norm_type, sp["mlp_norm"], x)
    return x + layers.apply_mlp(sp["mlp"], xm, cfg)


def zamba_forward(params: Dict, tokens: torch.Tensor, cfg: ArchConfig, *,
                  window: int = 0,
                  compute_dtype: torch.dtype = torch.bfloat16,
                  attn_chunk: int = 512, remat: bool = True,
                  use_kernel: Optional[bool] = None,
                  scan_kernel: Optional[bool] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits (B, S, V) float32, aux 0): the prefill and
    training forward.  Weights are cast to ``compute_dtype`` once per call
    (the float32 keys stay).  On the kernel path (``use_kernel``, or CUDA
    tensors when None) every Mamba2 layer's scan is the SSD kernel and
    every shared-attention application the flash kernels.
    ``scan_kernel`` overrides ``use_kernel`` for the scans alone: the loss
    passes False (the SSD kernel has no backward), so the scans run
    ``ssm.ssd_chunked`` while the attention keeps its kernels."""
    scan_use = use_kernel if scan_kernel is None else scan_kernel
    p = cast_weights(params, compute_dtype)
    n_seg, per = zamba_segments(cfg)
    x = layers.embed_tokens(p["embed"], tokens.long())
    positions = torch.arange(x.shape[1], device=x.device)

    def segment(s, x_):
        for l in range(per):
            lp = _index(p["segments"], s, l)
            xn = apply_norm(cfg.norm_type, lp["norm"], x_)
            y, _ = ssm_lib.apply_mamba2(lp["mamba"], xn, cfg,
                                        use_kernel=scan_use)
            x_ = x_ + y
        return _shared_attn_apply(p["shared"], x_, positions, cfg,
                                  window=window, attn_chunk=attn_chunk,
                                  use_kernel=use_kernel)

    x = _run_segments(n_seg, segment, x, remat)
    return _finish(p, x, cfg), torch.zeros((), dtype=torch.float32,
                                           device=x.device)


def init_zamba_cache(cfg: ArchConfig, batch: int, cache_len: int, *,
                     window: int = 0, dtype: torch.dtype = torch.bfloat16,
                     device="cuda") -> Dict:
    """Per-lane Mamba2 states (n_seg, per, batch, ...) and one KV cache
    per shared-attention application (n_seg, batch, slots, Hkv, D), a
    rolling buffer of ``min(window, cache_len)`` slots with a window."""
    dev = resolve_device(device)
    n_seg, per = zamba_segments(cfg)
    n_slots = min(window, cache_len) if window else cache_len
    shape = (n_seg, batch, n_slots, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {
        "mamba": ssm_lib.init_mamba2_state(cfg, batch, lead=(n_seg, per),
                                           device=dev),
        "shared_kv": {"k": torch.zeros(shape, dtype=dtype, device=dev),
                      "v": torch.zeros(shape, dtype=dtype, device=dev)},
        "slot_positions": -torch.ones((batch, n_slots), dtype=torch.int32,
                                      device=dev),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }


def zamba_decode_step(params: Dict, cache: Dict, tokens: torch.Tensor,
                      cfg: ArchConfig, *, window: int = 0,
                      compute_dtype: Optional[torch.dtype] = None
                      ) -> Tuple[torch.Tensor, Dict]:
    """tokens (B, 1) -> (logits (B, 1, V) float32, cache), the cache
    updated in place (``pos`` advances by one for every lane)."""
    _check_compute_dtype(params, compute_dtype)
    n_seg, per = zamba_segments(cfg)
    B = tokens.shape[0]
    pos = cache["pos"]
    x = layers.embed_tokens(params["embed"], tokens.long())
    n_slots = cache["shared_kv"]["k"].shape[2]
    slot = pos.long() % n_slots
    bidx = torch.arange(B, device=x.device)
    cache["slot_positions"][bidx, slot] = pos
    sp = params["shared"]
    for s in range(n_seg):
        for l in range(per):
            lp = _index(params["segments"], s, l)
            xn = apply_norm(cfg.norm_type, lp["norm"], x)
            y, new = ssm_lib.apply_mamba2(
                lp["mamba"], xn, cfg, state=_index(cache["mamba"], s, l))
            x = x + y
            _store(cache["mamba"], (s, l), new)
        # shared attention with this application's own KV cache
        xn = apply_norm(cfg.norm_type, sp["attn_norm"], x)
        q, k, v = layers.project_qkv(sp["attn"], xn, pos[:, None], cfg)
        kc, vc = cache["shared_kv"]["k"][s], cache["shared_kv"]["v"][s]
        kc[bidx, slot] = k[:, 0].to(kc.dtype)
        vc[bidx, slot] = v[:, 0].to(vc.dtype)
        a = layers.decode_attention(q, kc, vc, cache["slot_positions"], pos,
                                    window=window)
        x = x + layers.project_out(sp["attn"], a, cfg)
        xm = apply_norm(cfg.norm_type, sp["mlp_norm"], x)
        x = x + layers.apply_mlp(sp["mlp"], xm, cfg)
    cache["pos"] = pos + 1
    return _finish(params, x, cfg), cache


# ===========================================================================
# xLSTM
# ===========================================================================
def xlstm_segments(cfg: ArchConfig) -> Tuple[int, int]:
    per = cfg.xlstm.slstm_every
    assert per and cfg.n_layers % per == 0
    return cfg.n_layers // per, per - 1   # (n_segments, mlstm per segment)


def init_xlstm_params(cfg: ArchConfig, *, seed: int = 0, device="cuda",
                      dtype: torch.dtype = torch.bfloat16) -> Dict:
    """Random parameters with the reference's shapes and distributions,
    from a ``torch.Generator`` seeded with ``seed`` on ``device``; weights
    in ``dtype``, norms and the gate weights and biases float32."""
    dev = resolve_device(device)
    g = seeded_generator(dev, seed)
    n_seg, n_ml = xlstm_segments(cfg)
    kw = dict(device=dev, dtype=dtype)
    p = _embed_and_head(cfg, g, **kw)
    p["mlstm"] = _lead(xlstm_lib.mlstm_params(cfg, n_seg * n_ml, g, **kw),
                       (n_seg, n_ml))
    p["slstm"] = xlstm_lib.slstm_params(cfg, n_seg, g, **kw)
    return p


def xlstm_forward(params: Dict, tokens: torch.Tensor, cfg: ArchConfig, *,
                  window: int = 0,
                  compute_dtype: torch.dtype = torch.bfloat16,
                  attn_chunk: int = 512, remat: bool = True,
                  use_kernel: Optional[bool] = None,
                  scan_kernel: Optional[bool] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits (B, S, V) float32, aux 0): the prefill and
    training forward (``window`` and ``attn_chunk`` are accepted for the
    common signature).  On the kernel path every mLSTM layer's scan is the
    mLSTM kernel; the sLSTM stays a plain loop over time.  ``scan_kernel``
    overrides ``use_kernel`` for the scans: the loss passes False (the
    mLSTM kernel has no backward), so they run ``xlstm.mlstm_chunkwise``."""
    del window, attn_chunk
    scan_use = use_kernel if scan_kernel is None else scan_kernel
    p = cast_weights(params, compute_dtype)
    n_seg, n_ml = xlstm_segments(cfg)
    x = layers.embed_tokens(p["embed"], tokens.long())

    def segment(s, x_):
        for l in range(n_ml):
            x_, _ = xlstm_lib.apply_mlstm_block(
                _index(p["mlstm"], s, l), x_, cfg, use_kernel=scan_use)
        x_, _ = xlstm_lib.apply_slstm_block(_index(p["slstm"], s), x_, cfg)
        return x_

    x = _run_segments(n_seg, segment, x, remat)
    return _finish(p, x, cfg), torch.zeros((), dtype=torch.float32,
                                           device=x.device)


def init_xlstm_cache(cfg: ArchConfig, batch: int, cache_len: int, *,
                     window: int = 0, dtype: torch.dtype = torch.bfloat16,
                     device="cuda") -> Dict:
    """Per-lane mLSTM states (n_seg, n_mlstm, batch, ...) and sLSTM
    states (n_seg, batch, d); the states have fixed size and dtypes, so
    ``cache_len``, ``window`` and ``dtype`` are unused, as in the
    reference."""
    del cache_len, window, dtype
    dev = resolve_device(device)
    n_seg, n_ml = xlstm_segments(cfg)
    return {
        "mlstm": xlstm_lib.init_mlstm_state(cfg, batch, lead=(n_seg, n_ml),
                                            device=dev),
        "slstm": xlstm_lib.init_slstm_state(cfg, batch, lead=(n_seg,),
                                            device=dev),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }


def xlstm_decode_step(params: Dict, cache: Dict, tokens: torch.Tensor,
                      cfg: ArchConfig, *, window: int = 0,
                      compute_dtype: Optional[torch.dtype] = None
                      ) -> Tuple[torch.Tensor, Dict]:
    """tokens (B, 1) -> (logits (B, 1, V) float32, cache), the cache
    updated in place."""
    del window
    _check_compute_dtype(params, compute_dtype)
    n_seg, n_ml = xlstm_segments(cfg)
    x = layers.embed_tokens(params["embed"], tokens.long())
    for s in range(n_seg):
        for l in range(n_ml):
            x, new = xlstm_lib.apply_mlstm_block(
                _index(params["mlstm"], s, l), x, cfg,
                state=_index(cache["mlstm"], s, l))
            _store(cache["mlstm"], (s, l), new)
        x, new = xlstm_lib.apply_slstm_block(
            _index(params["slstm"], s), x, cfg,
            state=_index(cache["slstm"], s))
        _store(cache["slstm"], (s,), new)
    cache["pos"] = cache["pos"] + 1
    return _finish(params, x, cfg), cache
