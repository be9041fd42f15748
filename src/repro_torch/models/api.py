"""Unified model API of the port: every branch of
``repro/models/api.py::build_model`` — dense, moe, vlm, hybrid (zamba2),
ssm (xLSTM) and audio (whisper's encoder-decoder).

``build_model(cfg)`` returns a :class:`ModelAPI` with:
  * ``init(seed=0, device="cuda", dtype=torch.bfloat16)`` -> params
    (``dtype=torch.float32`` for training masters);
  * ``loss(params, batch, **kw)`` -> (loss, metrics) and
    ``forward(params, tokens, **kw)`` -> (logits, aux): the training path;
  * ``loss_parts(params, batch, **kw)`` -> (``lm_loss_parts``, MoE
    balance means): one position's share of ``loss`` over its rows,
    which ``transformer.parts_loss`` adds over positions before dividing
    (the gathered regime of sharded training, ``launch/specs.py``);
  * ``tp_loss(slices, batches, plans, **kw)`` -> (loss, metrics): the
    loss over data-parallel slices, each tensor-parallel under its
    ``tp_plan`` (the dense, MoE and VLM families);
  * ``init_cache(batch, cache_len, **kw)`` / ``decode_step`` — the
    dense-slot decode path (the oracle of the paged engine);
  * ``init_paged_cache(n_lanes, **kw)`` / ``paged_step`` — the
    rectangular (lanes, chunk) paged step, with ``paged_decode_step`` its
    q_len = 1 case — and ``ragged_step``, the flat-token paged step.
    Both multi-token steps return logits for EVERY row, the
    speculative-decode verification contract.
  * ``tp_plan(specs, devices)`` / ``tp_paged_step`` / ``tp_ragged_step``
    — the paged steps run tensor-parallel over mesh positions, each on
    its shard of the parameters and its own pools (the paged families).
  * ``effective_window(seq_len)`` -> attention window for a shape

The MoE family serves through the transformer's API and the VLM through
``models/vlm.py``'s, whose paged steps serve the text backbone (patches
enter through ``forward``).  The recurrent and audio families have no
paged steps (their decode state is O(1) recurrent, or a fixed encoder's
cross K/V beside a dense self cache), so they serve through the
dense-slot engine.  The audio family's ``forward`` takes ``frames=``
(B, encoder_positions, d_embed) and its ``loss`` reads
``batch["frames"]``.

The recurrent families' ``loss`` (the counterpart of the reference's
``_lm_loss_wrapper``) runs the SSD and mLSTM scans through their plain
chunkwise forms, by passing ``scan_kernel=False`` to the forward: the
scan kernels have no backward (nor do the reference's), while zamba2's
shared attention keeps ``use_kernel``'s rule (the flash kernels, forward
and backward, on CUDA tensors).  Prefill and serving keep the scan
kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec, recurrent, transformer, vlm

# full-attention archs switch to their long-context SWA variant above this
LONG_CONTEXT_THRESHOLD = 65_536


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ArchConfig
    init: Callable[..., Any]
    loss: Callable[..., Tuple[Any, Any]]
    forward: Callable[..., Tuple[Any, Any]]
    init_cache: Callable[..., Any]
    decode_step: Callable[..., Tuple[Any, Any]]
    loss_parts: Optional[Callable[..., Tuple[Any, Any]]] = None
    tp_loss: Optional[Callable[..., Tuple[Any, Any]]] = None
    init_paged_cache: Optional[Callable[..., Any]] = None
    paged_step: Optional[Callable[..., Tuple[Any, Any]]] = None
    paged_decode_step: Optional[Callable[..., Tuple[Any, Any]]] = None
    ragged_step: Optional[Callable[..., Tuple[Any, Any]]] = None
    # tensor-parallel serving: tp_plan(specs, devices) -> plan (specs None:
    # one position, nothing cut), and the paged steps over per-position
    # shards and caches, the layer loop of the single-device steps too
    tp_plan: Optional[Callable[..., Any]] = None
    tp_paged_step: Optional[Callable[..., Tuple[Any, Any]]] = None
    tp_ragged_step: Optional[Callable[..., Tuple[Any, Any]]] = None

    @property
    def supports_paged(self) -> bool:
        return (self.paged_step is not None
                or self.paged_decode_step is not None)

    @property
    def supports_ragged(self) -> bool:
        return self.ragged_step is not None

    @property
    def supports_spec(self) -> bool:
        """Speculative decode needs a multi-token step with per-row
        logits; the q_len = 1 step cannot verify draft chains."""
        return self.paged_step is not None

    def effective_window(self, seq_len: int) -> int:
        cfg = self.cfg
        if cfg.sliding_window:
            return cfg.sliding_window
        if cfg.long_context_window and seq_len > LONG_CONTEXT_THRESHOLD:
            return cfg.long_context_window
        return 0


# the recurrent families: (init, forward, init_cache, decode_step)
_RECURRENT = {
    "hybrid": (recurrent.init_zamba_params, recurrent.zamba_forward,
               recurrent.init_zamba_cache, recurrent.zamba_decode_step),
    "ssm": (recurrent.init_xlstm_params, recurrent.xlstm_forward,
            recurrent.init_xlstm_cache, recurrent.xlstm_decode_step),
}


def _lm_loss_parts(forward_fn, cfg: ArchConfig):
    """The recurrent families' share of the loss over one position's rows:
    ``forward_fn`` with the scans on their plain chunkwise forms
    (``scan_kernel=False``) then ``lm_loss_parts`` (no balance means: aux
    weight 0).  The reference always computes in bfloat16 here;
    ``compute_dtype`` lets a float32 run compare."""
    def loss_parts(params, batch, *, window: int = 0, attn_chunk: int = 512,
                   remat: bool = True,
                   compute_dtype: torch.dtype = torch.bfloat16,
                   use_kernel: Optional[bool] = None):
        logits, _ = forward_fn(params, batch["tokens"], cfg, window=window,
                               compute_dtype=compute_dtype,
                               attn_chunk=attn_chunk, remat=remat,
                               use_kernel=use_kernel, scan_kernel=False)
        return transformer.lm_loss_parts(logits, batch["labels"]), []

    return loss_parts


def _one_position(loss_parts, cfg: ArchConfig):
    """The one-device loss: ``loss_parts``' one share, divided."""
    def loss(params, batch, **kw):
        return transformer.parts_loss([loss_parts(params, batch, **kw)], cfg,
                                      batch["tokens"].device)

    return loss


def build_model(cfg: ArchConfig) -> ModelAPI:
    if cfg.family in _RECURRENT:
        init, forward, init_cache, decode_step = _RECURRENT[cfg.family]
        parts = _lm_loss_parts(forward, cfg)
        return ModelAPI(
            cfg=cfg,
            init=lambda **kw: init(cfg, **kw),
            loss=_one_position(parts, cfg),
            loss_parts=parts,
            forward=lambda p, t, **kw: forward(p, t, cfg, **kw),
            init_cache=lambda b, n, **kw: init_cache(cfg, b, n, **kw),
            decode_step=lambda p, c, t, **kw: decode_step(p, c, t, cfg,
                                                          **kw),
        )
    if cfg.family == "audio":
        return ModelAPI(
            cfg=cfg,
            init=lambda **kw: encdec.init_params(cfg, **kw),
            loss=lambda p, b, **kw: encdec.loss_fn(p, b, cfg, **kw),
            loss_parts=lambda p, b, **kw: encdec.loss_parts(p, b, cfg, **kw),
            forward=lambda p, t, **kw: encdec.forward(p, t, cfg, **kw),
            init_cache=lambda b, n, **kw: encdec.init_cache(cfg, b, n, **kw),
            decode_step=lambda p, c, t, **kw: encdec.decode_step(
                p, c, t, cfg, **kw),
        )
    # dense / moe through the transformer, vlm through its own module
    m = vlm if cfg.family == "vlm" else transformer
    return ModelAPI(
        cfg=cfg,
        init=lambda **kw: m.init_params(cfg, **kw),
        loss=lambda p, b, **kw: m.loss_fn(p, b, cfg, **kw),
        loss_parts=lambda p, b, **kw: m.loss_parts(p, b, cfg, **kw),
        tp_loss=lambda s, b, plans, **kw: m.tp_loss_fn(s, b, cfg, plans,
                                                       **kw),
        forward=lambda p, t, **kw: m.forward(p, t, cfg, **kw),
        init_cache=lambda b, n, **kw: m.init_cache(cfg, b, n, **kw),
        decode_step=lambda p, c, t, **kw: m.decode_step(p, c, t, cfg, **kw),
        init_paged_cache=lambda b, **kw: m.init_paged_cache(cfg, b, **kw),
        paged_step=lambda p, c, t, **kw: m.paged_step(p, c, t, cfg, **kw),
        paged_decode_step=lambda p, c, t, **kw: m.paged_decode_step(
            p, c, t, cfg, **kw),
        ragged_step=lambda p, c, t, **kw: m.ragged_step(p, c, t, cfg, **kw),
        tp_plan=lambda specs, devices: m.tp_plan(cfg, specs, devices),
        tp_paged_step=lambda p, c, t, plan, **kw: m.tp_paged_step(
            p, c, t, cfg, plan, **kw),
        tp_ragged_step=lambda p, c, t, plan, **kw: m.tp_ragged_step(
            p, c, t, cfg, plan, **kw),
    )
