"""Step functions of the port's training, prefill and serving paths: the
counterpart of ``make_loss_for_shape``, ``make_train_step_fn``,
``make_prefill_step_fn`` and ``make_serve_step_fn`` in
``repro/launch/specs.py``.

:func:`abstract_params` is the parameter tree on the ``meta`` device
(shapes and dtypes, no storage), which the sharding rules read.  The
reference's abstract input specs and its AOT/HLO step builders read XLA's
ahead-of-time compilation and have no counterpart here yet (ROADMAP
A10).  Options that the reference does not have (``compute_dtype``,
``use_kernel``) pass through ``**model_kw`` to the model's loss.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.shapes import InputShape
from repro_torch.models.api import ModelAPI
from repro_torch.models.common import cast_weights
from repro_torch.optim import Optimizer, adamw
from repro_torch.train.trainer import make_train_step


def abstract_params(api: ModelAPI, dtype: torch.dtype = torch.bfloat16):
    """The arch's parameter tree on the ``meta`` device: every leaf's
    shape and dtype, nothing allocated."""
    return api.init(seed=0, device="meta", dtype=dtype)


def make_loss_for_shape(api: ModelAPI, shape: InputShape, *,
                        attn_chunk: int = 512, remat: bool = True,
                        **model_kw) -> Callable:
    """loss(params, batch) -> (loss, metrics) at the attention window
    that ``shape``'s sequence length gives the arch; the audio family's
    loss gets no window, as the reference's."""
    kwargs: Dict[str, Any] = dict(attn_chunk=attn_chunk, remat=remat,
                                  **model_kw)
    if api.cfg.family != "audio":
        kwargs["window"] = api.effective_window(shape.seq_len)

    def loss(params, batch):
        return api.loss(params, batch, **kwargs)

    return loss


def _bf16(tree):
    """Every float leaf cast to bfloat16, differentiably: the reference's
    per-step bf16 gather of the master weights, without its sharding
    constraint (one card)."""
    return cast_weights(tree, torch.bfloat16, keep_norms=False)


def make_train_step_fn(api: ModelAPI, shape: InputShape, *,
                       lr: float = 1e-4, attn_chunk: int = 512,
                       remat: bool = True, pre_gather: bool = False,
                       **model_kw) -> Tuple[Callable, Optimizer]:
    """(train_step, opt): train_step(params, opt_state, batch) ->
    (params, opt_state, metrics) with ``adamw(lr, grad_clip_norm=1.0)``;
    metrics hold the loss's metrics, ``loss`` and ``grad_norm``."""
    loss = make_loss_for_shape(api, shape, attn_chunk=attn_chunk,
                               remat=remat, **model_kw)
    opt = adamw(lr, grad_clip_norm=1.0)

    def loss_of(p, b):
        return loss(_bf16(p) if pre_gather else p, b)

    return make_train_step(loss_of, opt), opt


def make_prefill_step_fn(api: ModelAPI, shape: InputShape, *,
                         attn_chunk: int = 512, **model_kw) -> Callable:
    """prefill_step(params, batch) -> the last position's logits (B, V) in
    bfloat16, from a no-remat forward over ``batch["tokens"]`` at the
    window ``shape``'s sequence length gives the arch: what serving
    admission needs for next-token sampling.  The VLM family's forward
    also takes ``batch["patches"]`` (prepended to the tokens), the audio
    family's ``batch["frames"]`` (the encoder's input; no window, as the
    reference)."""
    family = api.cfg.family
    kw: Dict[str, Any] = dict(attn_chunk=attn_chunk, remat=False, **model_kw)
    if family != "audio":
        kw["window"] = api.effective_window(shape.seq_len)
    extra = {"vlm": "patches", "audio": "frames"}.get(family)

    def prefill_step(params, batch):
        inputs = {extra: batch[extra]} if extra else {}
        logits, _ = api.forward(params, batch["tokens"], **inputs, **kw)
        return logits[:, -1].to(torch.bfloat16)

    return prefill_step


def make_serve_step_fn(api: ModelAPI, shape: InputShape) -> Callable:
    """serve_step(params, cache, tokens) -> (logits, cache): one
    ``decode_step`` at the window of ``shape``'s sequence length."""
    window = api.effective_window(shape.seq_len)

    def serve_step(params, cache, tokens):
        return api.decode_step(params, cache, tokens, window=window)

    return serve_step
