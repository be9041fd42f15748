"""Unified model API of the port: the dense, moe, vlm, hybrid (zamba2) and
ssm (xLSTM) branches of ``repro/models/api.py::build_model``.

``build_model(cfg)`` returns a :class:`ModelAPI` with:
  * ``init(seed=0, device="cuda", dtype=torch.bfloat16)`` -> params
    (``dtype=torch.float32`` for training masters);
  * ``loss(params, batch, **kw)`` -> (loss, metrics) and
    ``forward(params, tokens, **kw)`` -> (logits, aux): the training path;
  * ``init_cache(batch, cache_len, **kw)`` / ``decode_step`` — the
    dense-slot decode path (the oracle of the paged engine);
  * ``init_paged_cache(n_lanes, **kw)`` / ``paged_step`` — the
    rectangular (lanes, chunk) paged step, with ``paged_decode_step`` its
    q_len = 1 case — and ``ragged_step``, the flat-token paged step.
    Both multi-token steps return logits for EVERY row, the
    speculative-decode verification contract.
  * ``effective_window(seq_len)`` -> attention window for a shape

The MoE family serves through the transformer's API and the VLM through
``models/vlm.py``'s, whose paged steps serve the text backbone (patches
enter through ``forward``).  The recurrent families have no paged steps
(their decode state is O(1) recurrent, not a growing KV sequence), so
they serve through the dense-slot engine; their ``loss`` raises
(training them is ROADMAP A7).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

from repro_torch.configs.base import ArchConfig
from repro_torch.models import recurrent, transformer, vlm

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
    init_paged_cache: Optional[Callable[..., Any]] = None
    paged_step: Optional[Callable[..., Tuple[Any, Any]]] = None
    paged_decode_step: Optional[Callable[..., Tuple[Any, Any]]] = None
    ragged_step: Optional[Callable[..., Tuple[Any, Any]]] = None

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

    def resolve_paged_step(self):
        """The chunked step, or the q_len = 1 step when that is all the
        family provides."""
        return self.paged_step or self.paged_decode_step

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


def _no_training(cfg: ArchConfig):
    def loss(*_args, **_kw):
        raise NotImplementedError(
            f"training {cfg.name} ({cfg.family}) is not ported yet (ROADMAP "
            "A7): the SSD and mLSTM kernels have no backward")
    return loss


def build_model(cfg: ArchConfig) -> ModelAPI:
    if cfg.family in _RECURRENT:
        init, forward, init_cache, decode_step = _RECURRENT[cfg.family]
        return ModelAPI(
            cfg=cfg,
            init=lambda **kw: init(cfg, **kw),
            loss=_no_training(cfg),
            forward=lambda p, t, **kw: forward(p, t, cfg, **kw),
            init_cache=lambda b, n, **kw: init_cache(cfg, b, n, **kw),
            decode_step=lambda p, c, t, **kw: decode_step(p, c, t, cfg,
                                                          **kw),
        )
    if cfg.family not in ("dense", "moe", "vlm"):
        raise NotImplementedError(
            f"{cfg.family} models ({cfg.name}) are not ported yet: the "
            "audio (encoder-decoder) family is ROADMAP item A6b")
    # dense / moe through the transformer, vlm through its own module
    m = vlm if cfg.family == "vlm" else transformer
    return ModelAPI(
        cfg=cfg,
        init=lambda **kw: m.init_params(cfg, **kw),
        loss=lambda p, b, **kw: m.loss_fn(p, b, cfg, **kw),
        forward=lambda p, t, **kw: m.forward(p, t, cfg, **kw),
        init_cache=lambda b, n, **kw: m.init_cache(cfg, b, n, **kw),
        decode_step=lambda p, c, t, **kw: m.decode_step(p, c, t, cfg, **kw),
        init_paged_cache=lambda b, **kw: m.init_paged_cache(cfg, b, **kw),
        paged_step=lambda p, c, t, **kw: m.paged_step(p, c, t, cfg, **kw),
        paged_decode_step=lambda p, c, t, **kw: m.paged_decode_step(
            p, c, t, cfg, **kw),
        ragged_step=lambda p, c, t, **kw: m.ragged_step(p, c, t, cfg, **kw),
    )
