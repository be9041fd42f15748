"""LLaVA-NeXT-style VLM: a stubbed vision tower, a real projector and the
language-model backbone.

The counterpart of ``repro/models/vlm.py``.  The CLIP ViT tower is a stub:
the model consumes precomputed patch embeddings ``patches (B, n_tokens,
d_embed)`` shaped as the anyres tiling grid would emit them.  The 2-layer
MLP projector (tanh-approximate GELU) and the Mistral backbone
(``models/transformer.py`` on ``params["lm"]``) are real.  Patches enter
through :func:`forward` only: the decode and paged serving steps are
text only, as in the reference, so the serving engine takes no image
input.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device, seeded_generator
from repro_torch.models import transformer
from repro_torch.models.common import dense_init_, fan_in_std


def init_params(cfg: ArchConfig, *, seed: int = 0, device="cuda",
                dtype: torch.dtype = torch.bfloat16) -> Dict:
    """Random parameters with the reference's shapes and init scales:
    the projector from a generator seeded with ``seed``, the backbone
    from ``seed + 1``; weights in ``dtype``, biases zero."""
    assert cfg.frontend is not None and cfg.frontend.kind == "image_patches"
    dev = resolve_device(device)
    g = seeded_generator(dev, seed)
    d, e = cfg.d_model, cfg.frontend.d_embed
    kw = dict(device=dev, dtype=dtype)
    projector = {
        "w1": dense_init_(torch.empty((e, d), **kw), g, std=fan_in_std((e,))),
        "b1": torch.zeros((d,), **kw),
        "w2": dense_init_(torch.empty((d, d), **kw), g, std=fan_in_std((d,))),
        "b2": torch.zeros((d,), **kw),
    }
    return {"projector": projector,
            "lm": transformer.init_params(cfg, seed=seed + 1, device=dev,
                                          dtype=dtype)}


def project_patches(params: Dict, patches: torch.Tensor,
                    compute_dtype: torch.dtype = torch.bfloat16
                    ) -> torch.Tensor:
    """patches (B, n, d_embed) -> (B, n, d_model) in ``compute_dtype``:
    w1, tanh-approximate GELU, w2, each in ``compute_dtype``."""
    p = {k: v.to(compute_dtype) for k, v in params["projector"].items()}
    x = patches.to(compute_dtype)
    x = F.gelu(x @ p["w1"] + p["b1"], approximate="tanh")
    return x @ p["w2"] + p["b2"]


def forward(params: Dict, tokens: torch.Tensor, cfg: ArchConfig, *,
            patches: Optional[torch.Tensor] = None, window: int = 0,
            compute_dtype: torch.dtype = torch.bfloat16,
            attn_chunk: int = 512, remat: bool = True,
            use_kernel: Optional[bool] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) [+ patches (B, n, d_embed)] -> (logits (B, n + S, V)
    float32, aux): the projected patches come first."""
    extra = (project_patches(params, patches, compute_dtype)
             if patches is not None else None)
    return transformer.forward(params["lm"], tokens, cfg, window=window,
                               extra_embeds=extra,
                               compute_dtype=compute_dtype,
                               attn_chunk=attn_chunk, remat=remat,
                               use_kernel=use_kernel)


def loss_fn(params: Dict, batch: Dict, cfg: ArchConfig, *, window: int = 0,
            attn_chunk: int = 512, remat: bool = True,
            compute_dtype: torch.dtype = torch.bfloat16,
            use_kernel: Optional[bool] = None) -> Tuple[torch.Tensor, Dict]:
    """:func:`forward` then ``transformer.lm_loss``; the patch positions
    are labelled -1 (no loss).  The reference always computes in
    bfloat16 here; ``compute_dtype`` lets a float32 run compare."""
    patches = batch.get("patches")
    logits, aux = forward(params, batch["tokens"], cfg, patches=patches,
                          window=window, compute_dtype=compute_dtype,
                          attn_chunk=attn_chunk, remat=remat,
                          use_kernel=use_kernel)
    labels = batch["labels"]
    if patches is not None:
        pad = -torch.ones(patches.shape[:2], dtype=labels.dtype,
                          device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    aw = cfg.moe.router_aux_weight if cfg.moe else 0.0
    return transformer.lm_loss(logits, labels, aux, aw)


# image patches enter through forward (the prefill); the decode and paged
# steps below serve the text backbone
def init_cache(cfg: ArchConfig, batch: int, cache_len: int, **kw) -> Dict:
    return transformer.init_cache(cfg, batch, cache_len, **kw)


def decode_step(params: Dict, cache: Dict, tokens: torch.Tensor,
                cfg: ArchConfig, **kw):
    return transformer.decode_step(params["lm"], cache, tokens, cfg, **kw)


def init_paged_cache(cfg: ArchConfig, n_lanes: int, **kw) -> Dict:
    return transformer.init_paged_cache(cfg, n_lanes, **kw)


def paged_step(params: Dict, cache: Dict, tokens: torch.Tensor,
               cfg: ArchConfig, **kw):
    return transformer.paged_step(params["lm"], cache, tokens, cfg, **kw)


def ragged_step(params: Dict, cache: Dict, tokens: torch.Tensor,
                cfg: ArchConfig, **kw):
    return transformer.ragged_step(params["lm"], cache, tokens, cfg, **kw)


def paged_decode_step(params: Dict, cache: Dict, tokens: torch.Tensor,
                      cfg: ArchConfig, **kw):
    return transformer.paged_decode_step(params["lm"], cache, tokens, cfg,
                                         **kw)


# the tensor-parallel steps serve the backbone's shards
def tp_plan(cfg: ArchConfig, specs: Optional[Dict], devices):
    if specs is None:
        return transformer.tp_plan(cfg, None, devices)
    plan = transformer.tp_plan(cfg, specs["lm"], devices)
    plan.specs = {**specs, "lm": plan.specs}
    return plan


def tp_paged_step(shards, caches, tokens, cfg: ArchConfig, plan, **kw):
    return transformer.tp_paged_step([p["lm"] for p in shards], caches,
                                     tokens, cfg, plan, **kw)


def tp_ragged_step(shards, caches, tokens, cfg: ArchConfig, plan, **kw):
    return transformer.tp_ragged_step([p["lm"] for p in shards], caches,
                                      tokens, cfg, plan, **kw)
