"""Analytic FLOPs/bytes accounting per (arch x shape x step kind).

The port's copy of ``repro/roofline/analytic.py``, constant for constant:
the yardstick the reference validated against XLA's ``cost_analysis()``
on loop-free (1-layer, full-attention, no-remat) configs.  It computes a
step's work from the architecture config, faithful to the reference's
*implementation* (the GShard one-hot dispatch einsums of the MoE layer,
banded-attention work, remat recompute, optimizer traffic), not just
6*N*D.  Here ``launch/dryrun.py`` holds it against the FLOPs that
``torch.utils.flop_counter.FlopCounterMode`` counts in the port's step on
the ``meta`` device, and ``chip_smoke.py`` reads measured steps against
its bound.  Where the port's step does other work (float32 masters read
in training, every expert's FFN on its one capacity slot in the GShard
decode, whisper's cached cross K/V in decode), the account stays the
reference's; ``PERF.md`` records the gaps.

Conventions:
  * FLOPs: one multiply-add = 2 FLOPs; global (all devices).
  * bytes: global HBM traffic estimate: parameter reads (+ optimizer
    update traffic for training), activation reads/writes at layer
    boundaries, attention score/band traffic, KV-cache traffic for decode.
  * training multiplier: fwd=1, bwd=2, remat recompute=+1 -> 4x forward
    FLOPs with remat on (3x without).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import InputShape

BF16 = 2
F32 = 4
# activation traffic constant: reads+writes of the residual stream per block
ACT_RW = 6


@dataclasses.dataclass
class Account:
    flops: float = 0.0
    bytes: float = 0.0

    def add(self, flops: float = 0.0, bytes: float = 0.0) -> None:
        self.flops += flops
        self.bytes += bytes


# ---------------------------------------------------------------------------
# per-component forward FLOPs for ONE token (batch/seq multiplied by caller)
# ---------------------------------------------------------------------------
def _attn_proj_flops(cfg: ArchConfig) -> float:
    d, H, Hkv, Dh = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
    return 2 * d * (H * Dh) * 2 + 2 * d * (Hkv * Dh) * 2  # q,o + k,v


def _attn_score_flops_per_token(cfg: ArchConfig, seq: int, window: int,
                                kind: str, cache_len: int = 0) -> float:
    """scores + attn*V flops per query token."""
    H, Dh = cfg.n_heads, cfg.resolved_head_dim
    if kind == "decode":
        attended = min(window, cache_len) if window else cache_len
    elif window and window < seq:
        # banded schedule: each q chunk sees a (window + chunk) band
        attended = window
    else:
        attended = seq / 2  # causal average
    return 2 * 2 * attended * H * Dh


def _mlp_flops(cfg: ArchConfig, d_ff: int) -> float:
    n_mat = 3 if cfg.mlp_type in ("swiglu", "geglu") else 2
    return n_mat * 2 * cfg.d_model * d_ff


def _moe_flops_per_token(cfg: ArchConfig, group_tokens: int) -> Dict[str, float]:
    """Per-token MoE flops, split into parts (dispatch einsums included —
    the GShard one-hot dispatch is real MACs in the baseline program)."""
    mo = cfg.moe
    d = cfg.d_model
    E, k, de = mo.n_experts, mo.experts_per_token, mo.d_expert
    import math
    C = max(1, math.ceil(group_tokens * k / E * mo.capacity_factor))
    expert = 3 * 2 * d * de * k          # gate/up/down on k active experts
    router = 2 * d * E
    if mo.impl == "gather":
        # §Perf-1 gather dispatch: routing is integer gathers/scatters — no
        # MACs; only the k-way weighted combine remains.
        dispatch = 2 * k * d
    else:
        # dispatch + combine einsums 'gsec,gsd->egcd' / 'gsec,egcd->gsd':
        # total = 2 x (2 * G*S*E*C*d); per token = 4*E*C*d.  Since
        # C ~ S*k*cf/E this is an O(S) per-token (O(S^2) per step) GShard
        # dispatch penalty — the prime §Perf-1 target.
        dispatch = 4 * E * C * d
    shared = (3 * 2 * d * de * mo.n_shared_experts
              if mo.n_shared_experts else 0.0)
    return {"expert": expert, "router": router, "dispatch": dispatch,
            "shared": shared, "_capacity": C}


def _mamba_flops_per_token(cfg: ArchConfig) -> float:
    from repro_torch.models.ssm import dims as ssm_dims
    dm = ssm_dims(cfg)
    d, d_in, H, P, N, G = (cfg.d_model, dm["d_inner"], dm["H"], dm["P"],
                           dm["N"], dm["G"])
    Q = cfg.ssm.chunk_size
    proj = 2 * d * (2 * d_in + 2 * G * N + H) + 2 * d_in * d
    conv = 2 * cfg.ssm.d_conv * (d_in + 2 * G * N)
    # SSD intra-chunk: CB (Q*N per token-pair) + (CB*L)@x: per token ~
    #   2*Q*N (scores) + 2*Q*P ... per head
    intra = H * (2 * Q * N + 2 * Q * P)
    # inter-chunk state update + output: 2*P*N per head, twice
    inter = H * (2 * 2 * P * N)
    return proj + conv + intra + inter


def _mlstm_flops_per_token(cfg: ArchConfig, chunk: int = 128) -> float:
    from repro_torch.models.xlstm import mlstm_dims
    dm = mlstm_dims(cfg)
    d, d_in, H, hd = cfg.d_model, dm["d_in"], dm["H"], dm["hd"]
    Q = chunk
    proj = 2 * d * d_in * 2 + 3 * 2 * d_in * d_in + 2 * d_in * d \
        + 2 * d_in * 2 * H
    conv = 2 * 4 * d_in
    intra = H * (2 * Q * hd * 2)          # qk^T and SV within chunk
    inter = H * (2 * 2 * hd * hd)         # state read + update
    return proj + conv + intra + inter


def _slstm_flops_per_token(cfg: ArchConfig) -> float:
    d, H = cfg.d_model, cfg.n_heads
    hd = d // H
    ff = int(d * cfg.xlstm.slstm_proj_factor)
    gates = 2 * d * 4 * d                 # input gate projections
    rec = 4 * 2 * H * hd * hd             # recurrent block-diag matmuls
    ffn = 3 * 2 * d * ff
    return gates + rec + ffn


# ---------------------------------------------------------------------------
def forward_flops(cfg: ArchConfig, shape: InputShape, *,
                  window: int, tokens: int) -> Dict[str, float]:
    """Global forward FLOPs for one step, by component."""
    parts: Dict[str, float] = {}
    S = shape.seq_len
    kind = shape.kind
    cache_len = S if kind == "decode" else 0
    d, V = cfg.d_model, cfg.vocab_size
    layout = cfg.block_layout()

    attn_layers = sum(1 for b in layout if "attn" in b)
    mamba_layers = sum(1 for b in layout if b.startswith("mamba2"))
    mlstm_layers = sum(1 for b in layout if b == "mlstm")
    slstm_layers = sum(1 for b in layout if b == "slstm")

    if attn_layers:
        per_tok = (_attn_proj_flops(cfg)
                   + _attn_score_flops_per_token(cfg, S, window, kind,
                                                 cache_len))
        parts["attention"] = attn_layers * per_tok * tokens
        if cfg.moe is not None:
            mo = cfg.moe
            n_moe = attn_layers - mo.first_dense_layers
            group_tokens = 1 if kind == "decode" else S
            mf = _moe_flops_per_token(cfg, group_tokens)
            parts["moe_expert"] = n_moe * (mf["expert"] + mf["shared"]
                                           + mf["router"]) * tokens
            parts["moe_dispatch"] = n_moe * mf["dispatch"] * tokens
            if mo.first_dense_layers:
                dff = mo.dense_d_ff or mo.d_expert
                parts["mlp"] = (mo.first_dense_layers
                                * _mlp_flops(cfg, dff) * tokens)
        elif cfg.d_ff:
            parts["mlp"] = attn_layers * _mlp_flops(cfg, cfg.d_ff) * tokens

    if mamba_layers:
        parts["mamba"] = mamba_layers * _mamba_flops_per_token(cfg) * tokens
    if mlstm_layers:
        parts["mlstm"] = mlstm_layers * _mlstm_flops_per_token(cfg) * tokens
    if slstm_layers:
        parts["slstm"] = slstm_layers * _slstm_flops_per_token(cfg) * tokens

    # encoder (whisper): bidirectional attention over fixed 1500 positions
    if cfg.is_encoder_decoder:
        enc_tok = shape.global_batch * cfg.encoder_positions
        per_tok = (_attn_proj_flops(cfg)
                   + 2 * 2 * cfg.encoder_positions * cfg.n_heads
                   * cfg.resolved_head_dim)
        parts["encoder"] = cfg.n_encoder_layers * (
            per_tok + _mlp_flops(cfg, cfg.d_ff)) * enc_tok
        # cross attention in every decoder layer
        parts["cross_attn"] = cfg.n_layers * (
            2 * 2 * cfg.encoder_positions * cfg.n_heads
            * cfg.resolved_head_dim + _attn_proj_flops(cfg) / 2) * tokens

    if cfg.frontend is not None and cfg.frontend.kind == "image_patches":
        n_img = cfg.frontend.n_tokens * shape.global_batch
        if kind != "decode":
            parts["projector"] = (2 * cfg.frontend.d_embed * d
                                  + 2 * d * d) * n_img

    parts["lm_head"] = 2 * d * V * tokens
    parts["embed"] = 0.0  # gather, no MACs
    return parts


def step_account(cfg: ArchConfig, shape: InputShape, *, window: int,
                 n_params_total: int, n_params_active: int,
                 remat: bool = True) -> Dict[str, float]:
    """Full-step FLOPs + bytes for the shape's step kind."""
    S, B = shape.seq_len, shape.global_batch
    kind = shape.kind
    if kind == "decode":
        tokens = B
    elif cfg.family == "audio":
        tokens = B * min(S, cfg.max_decoder_positions or S)
    elif cfg.family == "vlm":
        tokens = B * S      # image tokens + text tokens fill seq_len
    else:
        tokens = B * S

    parts = forward_flops(cfg, shape, window=window, tokens=tokens)
    fwd = sum(parts.values())

    if kind == "train":
        mult = 4.0 if remat else 3.0
        flops = fwd * mult
        # bytes: params bf16 read fwd+bwd(+remat) + grads f32 write +
        # optimizer (read p,m,v + write p,m,v in f32) + activation traffic
        reads = (3 if remat else 2) * n_params_active * BF16
        opt = 6 * n_params_total * F32 + 2 * n_params_total * F32
        act = tokens * cfg.d_model * len(cfg.block_layout()) * ACT_RW * BF16
        bytes_ = reads + opt + act
    elif kind == "prefill":
        flops = fwd
        bytes_ = (n_params_active * BF16
                  + tokens * cfg.d_model * len(cfg.block_layout())
                  * ACT_RW * BF16)
    else:  # decode
        flops = fwd
        # decode is memory-bound: full active params stream per step +
        # KV-cache / state read
        layout = cfg.block_layout()
        attn_layers = sum(1 for b in layout if "attn" in b)
        slots = min(window, S) if window else S
        kv_bytes = (attn_layers * B * slots * cfg.n_kv_heads
                    * cfg.resolved_head_dim * 2 * BF16)
        state_bytes = 0.0
        if cfg.ssm is not None:
            from repro_torch.models.ssm import dims as ssm_dims
            dm = ssm_dims(cfg)
            n_mamba = sum(1 for b in layout if b.startswith("mamba2"))
            state_bytes = n_mamba * B * dm["H"] * dm["P"] * dm["N"] * F32 * 2
        if cfg.xlstm is not None:
            from repro_torch.models.xlstm import mlstm_dims
            dm = mlstm_dims(cfg)
            n_ml = sum(1 for b in layout if b == "mlstm")
            state_bytes = n_ml * B * dm["H"] * dm["hd"] * dm["hd"] * F32 * 2
        bytes_ = n_params_active * BF16 + kv_bytes + state_bytes
    return {"flops": flops, "bytes": bytes_, "fwd_flops": fwd,
            "parts": parts, "tokens": tokens}
