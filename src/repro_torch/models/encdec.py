"""Whisper-style encoder-decoder transformer backbone [arXiv:2212.04356].

The counterpart of ``repro/models/encdec.py``.  The mel-spectrogram + conv
frontend is a stub: the model consumes precomputed frame embeddings
``frames (B, encoder_positions, d_embed)``.  Everything downstream is
real: the learned frame projection, sinusoidal encoder positions, the
bidirectional encoder, learned decoder positions (clamped at
``max_decoder_positions - 1``, as the reference clamps them), the causal
self-attention + cross-attention decoder and the tied LM head.

Parameters keep the reference's tree: ``embed``, ``dec_pos``,
``frame_proj``, ``enc_final_norm``, ``dec_final_norm`` and the stacked
``enc_blocks``/``dec_blocks`` (leading layer axis).  A Python loop over
layers takes the place of ``lax.scan`` and ``torch.utils.checkpoint`` per
block that of ``jax.checkpoint``.

Attention: the decoder's causal self-attention goes through
``layers.causal_attention`` (the flash-attention kernels, forward and
backward, on CUDA tensors); the encoder's bidirectional attention and the
cross-attention are ``layers.full_attention``, plain PyTorch, as the
reference computes them outside any Pallas kernel.  ``project_qkv``
applies no RoPE to either (``max_decoder_positions`` is set), as in the
reference.  Serving runs ``decode_step`` on the dense-slot engine; its
cache's ``cross`` K/V start at zero, and only a caller that fills them
(``encoder_kv`` of ``encode``) conditions the decoder on audio, as in the
reference.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device, seeded_generator
from repro_torch.models import layers
from repro_torch.models.common import (apply_norm, cast_weights, embed_init_,
                                       norm_params)
from repro_torch.models.transformer import (_check_compute_dtype,
                                            attention_params, layer_params,
                                            lm_loss_parts, mlp_params,
                                            parts_loss)


def sinusoids(length: int, channels: int, device=None) -> torch.Tensor:
    """Whisper's sinusoidal position embedding (length, channels), float32."""
    f32 = dict(dtype=torch.float32, device=device)
    log_timescale = torch.log(torch.tensor(10000.0, **f32)) / (
        channels // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(channels // 2, **f32))
    scaled = torch.arange(length, **f32)[:, None] * inv[None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
def init_params(cfg: ArchConfig, *, seed: int = 0, device="cuda",
                dtype: torch.dtype = torch.bfloat16) -> Dict:
    """Random parameters with the reference's tree, shapes and init scales,
    from a ``torch.Generator`` seeded with ``seed`` on ``device``; weights
    and biases in ``dtype``, norms float32 (layernorm with bias, the
    reference's ``norm_params`` default).  ``frame_proj`` exists only with
    a frontend (the reference stores None without one)."""
    assert cfg.is_encoder_decoder
    dev = resolve_device(device)
    g = seeded_generator(dev, seed)
    d, V = cfg.d_model, cfg.vocab_size
    kw = dict(device=dev, dtype=dtype)

    def norms(n):
        return norm_params(cfg.norm_type, d, True, n=n, device=dev)

    p = {"embed": {"embedding": embed_init_(torch.empty((V, d), **kw), g)},
         "dec_pos": embed_init_(
             torch.empty((cfg.max_decoder_positions, d), **kw), g)}
    if cfg.frontend is not None:
        p["frame_proj"] = embed_init_(
            torch.empty((cfg.frontend.d_embed, d), **kw), g)
    p["enc_final_norm"] = {k: v[0] for k, v in norms(1).items()}
    p["dec_final_norm"] = {k: v[0] for k, v in norms(1).items()}
    ne, nd = cfg.n_encoder_layers, cfg.n_layers
    p["enc_blocks"] = {"attn_norm": norms(ne),
                       "attn": attention_params(cfg, ne, g, **kw),
                       "mlp_norm": norms(ne),
                       "mlp": mlp_params(cfg, ne, g, **kw)}
    p["dec_blocks"] = {"self_norm": norms(nd),
                       "self_attn": attention_params(cfg, nd, g, **kw),
                       "cross_norm": norms(nd),
                       "cross_attn": attention_params(cfg, nd, g, **kw),
                       "mlp_norm": norms(nd),
                       "mlp": mlp_params(cfg, nd, g, **kw)}
    return p


def _maybe_checkpoint(fn, remat: bool, *args):
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------
def encode(params: Dict, frames: torch.Tensor, cfg: ArchConfig, *,
           compute_dtype: torch.dtype = torch.bfloat16,
           remat: bool = True) -> torch.Tensor:
    """frames (B, T_enc, d_embed) -> (B, T_enc, d_model) in
    ``compute_dtype``: frame projection, sinusoidal positions, the
    bidirectional blocks (each checkpointed with ``remat`` while autograd
    records, so the T_enc^2 attention weights of every layer are not
    saved) and the final norm.  Weights are cast to ``compute_dtype`` once
    (a leaf already in it is used as is)."""
    p = cast_weights(params, compute_dtype)
    x = frames.to(compute_dtype)
    if p.get("frame_proj") is not None:
        x = x @ p["frame_proj"]
    T = x.shape[1]
    x = x + sinusoids(T, cfg.d_model, x.device).to(compute_dtype)
    positions = torch.arange(T, device=x.device)

    def block(bp, x_):
        xn = apply_norm(cfg.norm_type, bp["attn_norm"], x_)
        q, k, v = layers.project_qkv(bp["attn"], xn, positions, cfg)
        a = layers.full_attention(q, k, v, causal=False)
        x_ = x_ + layers.project_out(bp["attn"], a, cfg)
        xm = apply_norm(cfg.norm_type, bp["mlp_norm"], x_)
        return x_ + layers.apply_mlp(bp["mlp"], xm, cfg)

    for l in range(cfg.n_encoder_layers):
        x = _maybe_checkpoint(block, remat, layer_params(p["enc_blocks"], l),
                              x)
    return apply_norm(cfg.norm_type, p["enc_final_norm"], x)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------
def _dec_positions(cfg: ArchConfig, positions: torch.Tensor) -> torch.Tensor:
    return torch.clamp(positions, max=cfg.max_decoder_positions - 1).long()


def _cross_attention(bp: Dict, x: torch.Tensor, enc_kv: Dict,
                     cfg: ArchConfig) -> torch.Tensor:
    """x + cross-attention of x's queries over the encoder's K/V
    ``enc_kv`` {"k", "v"} (B, T_enc, Hkv, D); weights in x's dtype."""
    xn = apply_norm(cfg.norm_type, bp["cross_norm"], x)
    ca = bp["cross_attn"]
    wq = ca["wq"]
    q = (xn @ wq.reshape(wq.shape[0], -1)).reshape(*xn.shape[:-1],
                                                    *wq.shape[1:])
    if cfg.use_bias:
        q = q + ca["bq"]
    a = layers.full_attention(q, enc_kv["k"], enc_kv["v"], causal=False)
    return x + layers.project_out(ca, a, cfg)


def encoder_kv(params: Dict, enc_out: torch.Tensor,
               cfg: ArchConfig) -> Dict[str, torch.Tensor]:
    """Every decoder layer's cross-attention K/V from the encoder output:
    {"k", "v"} each (L, B, T_enc, Hkv, D) in ``enc_out``'s dtype (the
    weights cast to it, as the reference casts them), with the biases
    ``bk``/``bv`` when the config has biases."""
    ca = params["dec_blocks"]["cross_attn"]
    dt = enc_out.dtype

    def proj(w, b):                                   # w: (L, d, Hkv, D)
        L, d, Hkv, D = w.shape
        y = torch.einsum("bsd,lde->lbse", enc_out, w.to(dt).reshape(L, d, -1))
        y = y.reshape(L, *enc_out.shape[:2], Hkv, D)
        if cfg.use_bias:
            y = y + b.to(dt)[:, None, None]
        return y

    return {"k": proj(ca["wk"], ca.get("bk")),
            "v": proj(ca["wv"], ca.get("bv"))}


def decode_train(params: Dict, tokens: torch.Tensor, enc_out: torch.Tensor,
                 cfg: ArchConfig, *, attn_chunk: int = 512,
                 remat: bool = True,
                 use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Teacher-forced decoder in ``enc_out``'s dtype: tokens (B, S) ->
    logits (B, S, V) float32.  The self-attention follows
    ``layers.causal_attention``'s ``use_kernel`` rule (the flash kernels,
    forward and backward, on CUDA tensors); each block is checkpointed
    with ``remat`` while autograd records, the cross K/V outside it, as in
    the reference."""
    dt = enc_out.dtype
    p = cast_weights(params, dt)
    S = tokens.shape[1]
    positions = torch.arange(S, device=tokens.device)
    x = layers.embed_tokens(p["embed"], tokens.long())
    x = x + p["dec_pos"][_dec_positions(cfg, positions)]
    cross = encoder_kv(p, enc_out, cfg)

    def block(bp, k_c, v_c, x_):
        xn = apply_norm(cfg.norm_type, bp["self_norm"], x_)
        q, k, v = layers.project_qkv(bp["self_attn"], xn, positions, cfg)
        a = layers.causal_attention(q, k, v, chunk=attn_chunk,
                                    use_kernel=use_kernel)
        h = x_ + layers.project_out(bp["self_attn"], a, cfg)
        h = _cross_attention(bp, h, {"k": k_c, "v": v_c}, cfg)
        hm = apply_norm(cfg.norm_type, bp["mlp_norm"], h)
        return h + layers.apply_mlp(bp["mlp"], hm, cfg)

    for l in range(cfg.n_layers):
        x = _maybe_checkpoint(block, remat, layer_params(p["dec_blocks"], l),
                              cross["k"][l], cross["v"][l], x)
    x = apply_norm(cfg.norm_type, p["dec_final_norm"], x)
    return layers.lm_logits(None, p["embed"], x, True)


def forward(params: Dict, tokens: torch.Tensor, cfg: ArchConfig, *,
            frames: torch.Tensor, window: int = 0,
            compute_dtype: torch.dtype = torch.bfloat16,
            attn_chunk: int = 512, remat: bool = True,
            use_kernel: Optional[bool] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`encode` then :func:`decode_train`: (logits (B, S, V) float32,
    aux 0).  ``window`` is accepted for the common signature.  The
    reference's forward computes in bfloat16 whatever ``compute_dtype`` it
    is given; the port's honours it, so float32 runs compare."""
    del window
    p = cast_weights(params, compute_dtype)
    enc = encode(p, frames, cfg, compute_dtype=compute_dtype, remat=remat)
    logits = decode_train(p, tokens, enc, cfg, attn_chunk=attn_chunk,
                          remat=remat, use_kernel=use_kernel)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def loss_fn(params: Dict, batch: Dict, cfg: ArchConfig, **kw
            ) -> Tuple[torch.Tensor, Dict]:
    """:func:`forward` on ``batch["frames"]`` and ``batch["tokens"]``, then
    ``lm_loss`` against ``batch["labels"]``.  The reference always
    computes in bfloat16 here; ``compute_dtype`` lets a float32 run
    compare.  ``kw`` as :func:`loss_parts`'; the one-position case of
    ``transformer.parts_loss`` over positions' shares."""
    return parts_loss([loss_parts(params, batch, cfg, **kw)], cfg,
                      batch["tokens"].device)


def loss_parts(params: Dict, batch: Dict, cfg: ArchConfig, *,
               window: int = 0, attn_chunk: int = 512, remat: bool = True,
               compute_dtype: torch.dtype = torch.bfloat16,
               use_kernel: Optional[bool] = None):
    """One position's share of :func:`loss_fn` over its rows ``batch``:
    (``lm_loss_parts``, no balance means)."""
    logits, _ = forward(params, batch["tokens"], cfg, frames=batch["frames"],
                        window=window, compute_dtype=compute_dtype,
                        attn_chunk=attn_chunk, remat=remat,
                        use_kernel=use_kernel)
    return lm_loss_parts(logits, batch["labels"]), []


# ---------------------------------------------------------------------------
# Decode (serving)
# ---------------------------------------------------------------------------
def init_cache(cfg: ArchConfig, batch: int, cache_len: int, *,
               window: int = 0, dtype: torch.dtype = torch.bfloat16,
               device="cuda") -> Dict:
    """Dense per-lane self-attention KV (L, batch, cache_len, Hkv, D), the
    cross-attention K/V (L, batch, encoder_positions, Hkv, D), zero until a
    caller fills them from :func:`encoder_kv`, and the slot table and
    positions.  ``window`` is unused, as in the reference."""
    del window
    dev = resolve_device(device)
    Hkv, D, L = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_layers

    def zeros(n):
        return torch.zeros((L, batch, n, Hkv, D), dtype=dtype, device=dev)

    return {
        "self": {"k": zeros(cache_len), "v": zeros(cache_len)},
        "cross": {"k": zeros(cfg.encoder_positions),
                  "v": zeros(cfg.encoder_positions)},
        "slot_positions": -torch.ones((batch, cache_len), dtype=torch.int32,
                                      device=dev),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }


def decode_step(params: Dict, cache: Dict, tokens: torch.Tensor,
                cfg: ArchConfig, *, window: int = 0,
                compute_dtype: Optional[torch.dtype] = None
                ) -> Tuple[torch.Tensor, Dict]:
    """tokens (B, 1) -> (logits (B, 1, V) float32, cache), the cache
    updated in place (``pos`` advances by one for every lane); plain
    decode attention over the self cache, then cross-attention over
    ``cache["cross"]``.  Weights are used in their stored dtype."""
    del window
    _check_compute_dtype(params, compute_dtype)
    B = tokens.shape[0]
    pos = cache["pos"]
    x = layers.embed_tokens(params["embed"], tokens.long())
    x = x + params["dec_pos"][_dec_positions(cfg, pos)][:, None]
    sk, sv = cache["self"]["k"], cache["self"]["v"]
    slot = pos.long() % sk.shape[2]
    bidx = torch.arange(B, device=x.device)
    cache["slot_positions"][bidx, slot] = pos
    for l in range(cfg.n_layers):
        bp = layer_params(params["dec_blocks"], l)
        xn = apply_norm(cfg.norm_type, bp["self_norm"], x)
        q, k, v = layers.project_qkv(bp["self_attn"], xn, pos[:, None], cfg)
        sk[l][bidx, slot] = k[:, 0].to(sk.dtype)
        sv[l][bidx, slot] = v[:, 0].to(sv.dtype)
        a = layers.decode_attention(q, sk[l], sv[l], cache["slot_positions"],
                                    pos)
        x = x + layers.project_out(bp["self_attn"], a, cfg)
        x = _cross_attention(bp, x, {"k": cache["cross"]["k"][l],
                                     "v": cache["cross"]["v"][l]}, cfg)
        xm = apply_norm(cfg.norm_type, bp["mlp_norm"], x)
        x = x + layers.apply_mlp(bp["mlp"], xm, cfg)
    cache["pos"] = pos + 1
    x = apply_norm(cfg.norm_type, params["dec_final_norm"], x)
    return layers.lm_logits(None, params["embed"], x, True), cache
