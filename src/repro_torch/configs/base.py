"""Architecture configuration system (the port's own copy).

A copy of the reference package's ``configs/base.py``: every architecture
is a frozen :class:`ArchConfig` registered under its public id, and
``smoke_variant()`` derives the reduced config (<=2 layers, d_model<=512,
<=4 experts) used by the CPU tests.  The port keeps its own copy so it
never imports the JAX package; only the archs the port can serve are
registered (``repro_torch/configs/__init__.py``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, Optional, Tuple

# ---------------------------------------------------------------------------
# Block kinds used by hybrid / xLSTM stack layouts.
# ---------------------------------------------------------------------------
ATTN = "attn"          # standard (GQA) attention + MLP transformer block
MAMBA2 = "mamba2"      # Mamba2 SSD block
SLSTM = "slstm"        # xLSTM sLSTM block (scalar memory)
MLSTM = "mlstm"        # xLSTM mLSTM block (matrix memory)
SHARED_ATTN = "shared_attn"  # zamba2-style shared-weight attention block


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts sub-config (fine-grained DeepSeek style supported)."""

    n_experts: int
    experts_per_token: int
    d_expert: int                 # per-expert FFN hidden dim
    n_shared_experts: int = 0     # always-on shared experts (DeepSeek/Moonlight)
    first_dense_layers: int = 0   # leading layers that use a dense MLP instead
    dense_d_ff: int = 0           # FFN width of those dense layers (0 -> d_expert)
    router_aux_weight: float = 0.01  # load-balance auxiliary loss weight
    router_jitter: float = 0.0
    capacity_factor: float = 1.25  # expert capacity factor for dropped-token routing
    # "gshard": one-hot dispatch/combine einsums (paper-faithful baseline);
    # "gather": zero-FLOP gather/scatter dispatch (beyond-paper, §Perf-1)
    impl: str = "gshard"


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD sub-config."""

    d_state: int = 64
    d_conv: int = 4
    expand: int = 2              # d_inner = expand * d_model
    head_dim: int = 64           # SSD head dim -> n_ssm_heads = d_inner // head_dim
    chunk_size: int = 256        # chunked-scan block length
    n_groups: int = 1            # B/C groups (like GQA for SSM)


@dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 8         # one sLSTM block per this many blocks (xLSTM[7:1])
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 1.3334
    conv1d_kernel: int = 4


@dataclass(frozen=True)
class FrontendStub:
    """Modality frontend carve-out: precomputed embeddings, right shapes only.

    ``kind`` in {"audio_frames", "image_patches"}.  ``n_tokens`` is the number
    of embedding vectors the (stubbed) frontend emits; ``d_embed`` their width
    (projected to d_model by a real learned projection in the backbone).
    """

    kind: str
    n_tokens: int
    d_embed: int


@dataclass(frozen=True)
class ArchConfig:
    # -- identity ----------------------------------------------------------
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    source: str                  # citation (arXiv / hf model card)

    # -- core dims ---------------------------------------------------------
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // n_heads

    # -- attention ---------------------------------------------------------
    rope_theta: float = 10000.0
    sliding_window: int = 0      # 0 = full attention
    # sliding window used only for the long_500k shape when the base model is
    # full-attention (beyond-paper long-context variant; see DESIGN.md):
    long_context_window: int = 0
    attn_logit_softcap: float = 0.0
    qk_norm: bool = False        # qwen3-style per-head q/k RMSNorm

    # -- block flavour -----------------------------------------------------
    mlp_type: str = "swiglu"     # swiglu | geglu | gelu (non-gated)
    norm_type: str = "rmsnorm"   # rmsnorm | layernorm
    use_bias: bool = False
    parallel_block: bool = False  # command-r style parallel attn+mlp
    tie_embeddings: bool = False
    scale_embeddings: bool = False  # gemma: multiply embeds by sqrt(d_model)

    # -- sub-family configs --------------------------------------------------
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None

    # hybrid stack layout: zamba2 applies a shared attention block every k
    # mamba layers (weights tied across applications).
    hybrid_attn_every: int = 0

    # -- encoder-decoder (whisper) ------------------------------------------
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_positions: int = 0   # fixed encoder sequence length (1500 whisper)
    max_decoder_positions: int = 0  # 0 = unlimited (rope); whisper: 448 learned

    # -- modality frontend stub ----------------------------------------------
    frontend: Optional[FrontendStub] = None

    # -- shape-support policy -------------------------------------------------
    supports_long_context: bool = True   # can run long_500k (natively or via SWA)
    supports_decode: bool = True
    long_context_skip_reason: str = ""

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def attn_out_dim(self) -> int:
        return self.n_heads * self.resolved_head_dim

    @property
    def is_moe(self) -> bool:
        return self.moe is not None

    def block_layout(self) -> Tuple[str, ...]:
        """Per-layer block kinds for the full stack (decoder side)."""
        if self.xlstm is not None:
            k = self.xlstm.slstm_every
            return tuple(
                SLSTM if (i % k == k - 1) else MLSTM for i in range(self.n_layers)
            )
        if self.ssm is not None and self.hybrid_attn_every:
            k = self.hybrid_attn_every
            return tuple(
                # a mamba layer, with a shared attn block fused after every k-th
                (MAMBA2 + "+" + SHARED_ATTN) if (i % k == k - 1) else MAMBA2
                for i in range(self.n_layers)
            )
        if self.ssm is not None:
            return tuple(MAMBA2 for _ in range(self.n_layers))
        return tuple(ATTN for _ in range(self.n_layers))

    # ------------------------------------------------------------------
    def smoke_variant(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        d_model = min(self.d_model, 256)
        n_heads = max(1, min(self.n_heads, 4))
        # keep the GQA ratio if possible
        ratio = max(1, self.n_heads // max(1, self.n_kv_heads))
        n_kv = max(1, n_heads // ratio)
        head_dim = 64 if self.head_dim else 0
        updates: Dict[str, object] = dict(
            n_layers=2,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            long_context_window=(
                min(self.long_context_window, 64) if self.long_context_window else 0
            ),
        )
        if self.moe is not None:
            updates["moe"] = replace(
                self.moe,
                n_experts=min(self.moe.n_experts, 4),
                experts_per_token=min(self.moe.experts_per_token, 2),
                d_expert=min(self.moe.d_expert, 128),
                n_shared_experts=min(self.moe.n_shared_experts, 1),
                first_dense_layers=min(self.moe.first_dense_layers, 1),
                dense_d_ff=min(self.moe.dense_d_ff, 256) if self.moe.dense_d_ff else 0,
            )
        if self.ssm is not None:
            updates["ssm"] = replace(
                self.ssm,
                d_state=min(self.ssm.d_state, 16),
                head_dim=32,
                chunk_size=32,
            )
        if self.xlstm is not None:
            updates["xlstm"] = replace(self.xlstm, slstm_every=2)
        if self.hybrid_attn_every:
            updates["hybrid_attn_every"] = 2
        if self.is_encoder_decoder:
            updates["n_encoder_layers"] = 2
            updates["encoder_positions"] = min(self.encoder_positions, 64)
            updates["max_decoder_positions"] = (
                min(self.max_decoder_positions, 64) if self.max_decoder_positions else 0
            )
        if self.frontend is not None:
            updates["frontend"] = replace(
                self.frontend,
                n_tokens=min(self.frontend.n_tokens, 16),
                d_embed=min(self.frontend.d_embed, 64),
            )
        return replace(self, **updates)  # type: ignore[arg-type]

    def validate(self) -> None:
        assert self.n_heads % max(1, self.n_kv_heads) == 0, self.name
        assert self.family in {"dense", "moe", "ssm", "hybrid", "audio", "vlm"}
        if self.family == "moe":
            assert self.moe is not None
        if self.is_encoder_decoder:
            assert self.n_encoder_layers > 0 and self.encoder_positions > 0


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
_REGISTRY: Dict[str, Callable[[], ArchConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ArchConfig]):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        # import side-effect registration
        from repro_torch import configs as _  # noqa: F401

        if name not in _REGISTRY:
            raise KeyError(
                f"unknown arch {name!r}; available: {sorted(_REGISTRY)}"
            )
    cfg = _REGISTRY[name]()
    cfg.validate()
    return cfg


def available_archs() -> Tuple[str, ...]:
    from repro_torch import configs as _  # noqa: F401

    return tuple(sorted(_REGISTRY))
