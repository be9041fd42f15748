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
    bfloat16 here; ``compute_dtype`` lets a float32 run compare.  The
    one-position case of :func:`tp_loss_fn`."""
    return transformer.parts_loss(
        [loss_parts(params, batch, cfg, window=window, attn_chunk=attn_chunk,
                    remat=remat, compute_dtype=compute_dtype,
                    use_kernel=use_kernel)], cfg, batch["tokens"].device)


def loss_parts(params: Dict, batch: Dict, cfg: ArchConfig, **kw):
    """One position's share of :func:`loss_fn` over its rows ``batch``
    (``transformer.loss_parts``'s, the patches projected first)."""
    plan = tp_plan(cfg, None, [batch["tokens"].device])
    return _slice_parts([params], batch, cfg, plan, **kw)


def _projector_cut(plan) -> bool:
    """Whether ``plan``'s specs cut the projector over "model": w1's
    output dim and w2's rows (``launch/sharding.py``'s rules)."""
    if plan.specs is None:
        return False
    spec = plan.specs["projector"]
    cut = transformer._cut(spec["w1"], plan.tp)
    if cut != transformer._cut(spec["w2"], plan.tp):
        raise ValueError("the projector's w1 and w2 must be cut together")
    return cut


def _tp_project(shards, patches, plan,
                compute_dtype: torch.dtype) -> list:
    """Each position's projected patches (B, n, d_model).  With the
    projector cut, position s computes its slice of the hidden units (its
    columns of w1 and its slice of the replicated b1, then the GELU) and
    their share of the output through its rows of w2; one reduce sums
    the shares and b2 is added once after it.  Otherwise every position
    projects whole."""
    if not _projector_cut(plan):
        return [project_patches(p, x, compute_dtype)
                for p, x in zip(shards, patches)]
    parts = []
    for s, (p, x) in enumerate(zip(shards, patches)):
        pr = {k: v.to(compute_dtype) for k, v in p["projector"].items()}
        n = pr["w1"].shape[-1]
        b1 = pr["b1"][s * n:(s + 1) * n]
        h = F.gelu(x.to(compute_dtype) @ pr["w1"] + b1, approximate="tanh")
        parts.append(h @ pr["w2"])
    return [y + p["projector"]["b2"].to(compute_dtype)
            for y, p in zip(plan.reduce(parts), shards)]


def _slice_parts(shards, batch: Dict, cfg: ArchConfig, plan, *,
                 compute_dtype: torch.dtype = torch.bfloat16, **kw):
    """One tensor-parallel slice's share of the loss: the projected
    patches (:func:`_tp_project`) enter ``transformer.slice_parts`` as
    the positions' extra embeddings, labelled -1."""
    patches = batch.get("patches")
    rows = {"tokens": batch["tokens"], "labels": batch["labels"]}
    if patches is not None:
        rows["extra_embeds"] = _tp_project(
            shards, [patches.to(d) for d in plan.devices], plan,
            compute_dtype)
    return transformer.slice_parts([p["lm"] for p in shards], rows, cfg,
                                   plan, compute_dtype=compute_dtype, **kw)


def tp_loss_fn(slices, batches, cfg: ArchConfig, plans, **kw):
    """:func:`loss_fn` over data-parallel slices, each tensor-parallel
    (``transformer.tp_loss_fn``'s layout): slice i's share from its
    positions' local trees ``slices[i]`` (``{"projector", "lm"}``) under
    ``plans[i]`` over its rows ``batches[i]``, the shares added before
    dividing."""
    return transformer.parts_loss(
        [_slice_parts(shards, batch, cfg, plan, **kw)
         for shards, batch, plan in zip(slices, batches, plans)],
        cfg, plans[0].devices[0])


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
