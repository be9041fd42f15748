"""Shared model utilities: initializers, norms, activations, RoPE, and
the cast of float32 master weights to the compute dtype.

The counterpart of ``repro/models/common.py``.  Parameters are plain
dicts of tensors.  The reference keeps float32 masters and casts them
inside every contraction.  The port's layer functions expect weights
already in the compute dtype: the serving paths store each weight once
in it, and the training forward casts float32 masters once per call
(:func:`cast_weights`).  Norm parameters stay float32 either way, since
norms are computed in float32 as in the reference.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Initializers (same distributions and scales as the reference; the bits
# differ, since torch and jax generators differ)
# ---------------------------------------------------------------------------
def dense_init_(out: torch.Tensor, generator: torch.Generator, *,
                std: float) -> torch.Tensor:
    """Fill ``out`` with a truncated normal of ``std`` cut at +-2 std (the
    reference's ``dense_init``: fan-in std = scale / sqrt(fan_in)),
    sampled in float32 and stored in ``out``'s dtype."""
    tmp = torch.empty(out.shape, dtype=torch.float32, device=out.device)
    torch.nn.init.trunc_normal_(tmp, mean=0.0, std=std, a=-2.0 * std,
                                b=2.0 * std, generator=generator)
    return out.copy_(tmp)


def fan_in_std(shape: Sequence[int], *, in_axis: int = 0,
               scale: float = 1.0) -> float:
    """The reference's variance-scaling std: ``scale / sqrt(fan_in)``."""
    return scale / (shape[in_axis] ** 0.5)


def embed_init_(out: torch.Tensor, generator: torch.Generator
                ) -> torch.Tensor:
    """Normal(0, 0.02), as the reference's ``embed_init``."""
    tmp = torch.empty(out.shape, dtype=torch.float32, device=out.device)
    tmp.normal_(0.0, 0.02, generator=generator)
    return out.copy_(tmp)


def norm_params(kind: str, d: int, use_bias: bool, *, n: int,
                device) -> Dict[str, torch.Tensor]:
    """``n`` stacked norms (ones scale, zero bias for layernorm), float32."""
    p = {"scale": torch.ones((n, d), dtype=torch.float32, device=device)}
    if kind != "rmsnorm" and use_bias:
        p["bias"] = torch.zeros((n, d), dtype=torch.float32, device=device)
    return p


def is_norm_key(key: str) -> bool:
    """Norm parameters (``attn_norm``, ``final_norm``, ``q_norm_scale``
    ...), which stay float32 whatever the compute dtype."""
    return key.endswith(("norm", "norm_scale"))


# recurrent-family parameters that the reference reads in float32
# arithmetic whatever the compute dtype (Mamba2's decay and step bias,
# the mLSTM and sLSTM gates)
FLOAT32_KEYS = frozenset({"A_log", "dt_bias", "w_if", "b_i", "b_f",
                          "w_gates", "b_gates", "r_gates"})


def keeps_float32(key: str) -> bool:
    """Parameters stored and read in float32 whatever the compute dtype:
    the norms and :data:`FLOAT32_KEYS`."""
    return is_norm_key(key) or key in FLOAT32_KEYS


# parameters the reference reads in float32 from their stored precision
# (the MoE router): a forward leaves them as stored, neither cast to the
# compute dtype nor widened, so float32 masters route in float32 and a
# bfloat16 serving checkpoint routes on its bfloat16 weights
STORED_PRECISION_KEYS = frozenset({"router"})


def cast_weights(tree: Dict, dtype: torch.dtype, *,
                 keep_norms: bool = True) -> Dict:
    """Every float leaf cast to ``dtype`` with a differentiable ``.to`` (a
    leaf already in ``dtype`` is returned as is), so gradients reach the
    masters.  With ``keep_norms`` the norms and the other float32 keys
    (:func:`keeps_float32`) and :data:`STORED_PRECISION_KEYS` stay as
    stored.  Lists (an MoE config's ``head_blocks``) are walked like
    dicts."""
    def keep(k: str) -> bool:
        return keep_norms and (keeps_float32(k)
                               or k in STORED_PRECISION_KEYS)

    def conv(node, is_norm: bool):
        if isinstance(node, dict):
            return {k: conv(v, is_norm or keep(k)) for k, v in node.items()}
        if isinstance(node, list):
            return [conv(v, is_norm) for v in node]
        if is_norm or not node.is_floating_point():
            return node
        return node.to(dtype)

    return conv(tree, False)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def apply_norm(kind: str, p: Dict[str, torch.Tensor], x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """Normalize in float32, return in ``x.dtype``."""
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * p["scale"]
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"]
        if "bias" in p:
            out = out + p["bias"]
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------
def activation(name: str, x: torch.Tensor) -> torch.Tensor:
    """``gelu`` is the tanh approximation, as ``jax.nn.gelu`` defaults."""
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    if name == "silu":
        return F.silu(x)
    if name == "relu":
        return F.relu(x)
    raise ValueError(name)


# ---------------------------------------------------------------------------
# Rotary position embeddings (half-split)
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D) with positions (..., S) or (S,)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)            # (D/2,)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                    # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
