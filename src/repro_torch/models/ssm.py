"""Mamba2 (SSD) block: the chunked state-space dual form.

The counterpart of ``repro/models/ssm.py``.  The sequence is processed in
chunks: a quadratic intra-chunk term plus a linear inter-chunk recurrence
over the chunk index.  :func:`ssd_chunked` is that form in plain PyTorch,
the plain version of the SSD kernel (``kernels/ssm_scan.py``);
:func:`apply_mamba2`'s prefill branch goes through
``kernels.ops.ssd_scan_heads``, which runs the kernel on CUDA tensors and
:func:`ssd_chunked` on CPU tensors.

Shapes follow the Mamba2 paper: heads H = d_inner / head_dim (P = head_dim),
state size N = d_state, B/C shared across heads in ``n_groups`` groups.
Parameters arrive with their matrices in the compute dtype and ``A_log``,
``dt_bias`` and the norm scale in float32, which the reference reads in
float32 arithmetic (``common.keeps_float32``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, SSMConfig
from repro_torch.models.common import dense_init_, fan_in_std


def _cfg(cfg: ArchConfig) -> SSMConfig:
    assert cfg.ssm is not None
    return cfg.ssm


def dims(cfg: ArchConfig) -> Dict[str, int]:
    s = _cfg(cfg)
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.head_dim
    return dict(d_inner=d_inner, H=H, P=s.head_dim, N=s.d_state,
                G=s.n_groups, K=s.d_conv)


# ---------------------------------------------------------------------------
def mamba2_params(cfg: ArchConfig, n: int, generator: torch.Generator, *,
                  device, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """``n`` stacked Mamba2 layers with the reference's distributions:
    dt from U[1e-3, 1e-1] through the inverse softplus into ``dt_bias``,
    A from U[1, 16] into ``A_log``, D ones, the conv weight normal with
    std 1/sqrt(K * conv_dim).  Matrices in ``dtype``; ``dt_bias``,
    ``A_log`` and ``norm_scale`` float32."""
    dm = dims(cfg)
    d, d_in, H, N, G, K = (cfg.d_model, dm["d_inner"], dm["H"], dm["N"],
                           dm["G"], dm["K"])
    conv_dim = d_in + 2 * G * N
    g = generator
    f32 = dict(dtype=torch.float32, device=device)
    p = {
        # fused input projection: [z, x, B, C, dt]
        "w_in": torch.empty((n, d, 2 * d_in + 2 * G * N + H), dtype=dtype,
                            device=device),
        "conv_w": torch.empty((n, K, conv_dim), dtype=dtype, device=device),
        "conv_b": torch.zeros((n, conv_dim), dtype=dtype, device=device),
        "D": torch.ones((n, H), dtype=dtype, device=device),
        "norm_scale": torch.ones((n, d_in), **f32),
        "w_out": torch.empty((n, d_in, d), dtype=dtype, device=device),
    }
    dt = torch.exp(torch.rand((n, H), generator=g, **f32)
                   * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    p["dt_bias"] = dt + torch.log(-torch.expm1(-dt))
    p["A_log"] = torch.log(1.0 + 15.0 * torch.rand((n, H), generator=g,
                                                    **f32))
    for l in range(n):
        dense_init_(p["w_in"][l], g, std=fan_in_std((d,)))
        p["conv_w"][l].copy_(torch.randn((K, conv_dim), generator=g, **f32)
                             / (K * conv_dim) ** 0.5)
        dense_init_(p["w_out"][l], g, std=fan_in_std((d_in,)))
    return p


def _split_proj(zxbcdt: torch.Tensor, cfg: ArchConfig):
    dm = dims(cfg)
    d_in, G, N, H = dm["d_inner"], dm["G"], dm["N"], dm["H"]
    return torch.split(zxbcdt, [d_in, d_in, G * N, G * N, H], dim=-1)


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv. x: (B,S,Cd); w: (K,Cd). state: (B,K-1,Cd)."""
    K = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    S = x.shape[1]
    out = xp[:, 0:S] * w[0].to(x.dtype)
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[i].to(x.dtype)
    return out + b.to(x.dtype)


# ---------------------------------------------------------------------------
# Chunked SSD scan (plain PyTorch; the plain version of kernels/ssm_scan.py)
# ---------------------------------------------------------------------------
def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """State-space dual chunked scan, with the reference's roundings: the
    masked decay weights, the per-chunk state inputs and the carried
    state meet x in x's dtype.

    x:  (B, L, H, P)   inputs per head
    dt: (B, L, H)      positive step sizes (already softplus'd)
    A:  (H,)           negative decay rates
    Bm: (B, L, G, N)   input maps; Cm: (B, L, G, N) output maps
    Returns (y (B,L,H,P), final_state (B,H,P,N) float32).
    """
    B, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(chunk, L)
    if L % Q:
        raise ValueError(f"sequence {L} is not a multiple of chunk {Q}")
    nc = L // Q
    rep = H // G
    f32 = torch.float32

    Bh = torch.repeat_interleave(Bm, rep, dim=2)      # (B,L,H,N)
    Ch = torch.repeat_interleave(Cm, rep, dim=2)
    xr = x.reshape(B, nc, Q, H, P)
    dtr = dt.reshape(B, nc, Q, H).to(f32)
    Br = Bh.reshape(B, nc, Q, H, N)
    Cr = Ch.reshape(B, nc, Q, H, N)

    dA = dtr * A.to(f32)                              # (B,nc,Q,H) negative
    cum = torch.cumsum(dA, dim=2)                     # inclusive, in chunk

    # intra-chunk decay matrix: exp(cum_i - cum_j) for j <= i, else 0.
    # The mask goes in before the exp: above the diagonal cum_i - cum_j > 0
    # overflows float32 at the published chunk (up to 127 x 1.6), and the
    # reference's where(tri, exp(diff), 0) then back-propagates 0 x inf =
    # NaN.  The values are the reference's bit for bit (exp(-inf) = 0).
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,nc,Qi,Qj,H)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    Lmat = torch.exp(torch.where(
        tri[None, None, :, :, None], diff,
        torch.tensor(float("-inf"), dtype=f32, device=x.device)))

    xdt = xr * dtr[..., None].to(x.dtype)             # (B,nc,Q,H,P)

    # intra-chunk (diagonal block) output
    CB = torch.einsum("bcqhn,bckhn->bcqkh", Cr, Br).to(f32)
    W = CB * Lmat                                     # (B,nc,Q,Q,H)
    y_diag = torch.einsum("bcqkh,bckhp->bcqhp", W.to(x.dtype), xdt)

    # per-chunk input to the recurrent state
    decay_last = torch.exp(cum[:, :, -1:, :] - cum)   # (B,nc,Q,H)
    states_in = torch.einsum("bckhn,bckhp->bchpn",
                             Br * decay_last.to(x.dtype)[..., None], xdt)
    chunk_decay = torch.exp(cum[:, :, -1, :])         # (B,nc,H)

    state = (torch.zeros((B, H, P, N), dtype=f32, device=x.device)
             if init_state is None else init_state.to(f32))
    prev = []                                         # state BEFORE chunk c
    s_in = states_in.to(f32)
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + s_in[:, c]
    prev_states = torch.stack(prev, dim=1)            # (B,nc,H,P,N)

    # inter-chunk (off-diagonal) output: the carried state's contribution
    in_decay = torch.exp(cum)                         # (B,nc,Q,H)
    y_off = torch.einsum("bcqhn,bchpn->bcqhp", Cr,
                         prev_states.to(x.dtype)) * in_decay.to(
                             x.dtype)[..., None]

    y = (y_diag + y_off).reshape(B, L, H, P)
    return y, state


def ssd_decode_step(state: torch.Tensor, x_t: torch.Tensor,
                    dt_t: torch.Tensor, A: torch.Tensor, B_t: torch.Tensor,
                    C_t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrent step.  state (B,H,P,N); x_t (B,H,P); dt_t (B,H);
    B_t/C_t (B,G,N) -> broadcast to heads."""
    H = state.shape[1]
    rep = H // B_t.shape[1]
    f32 = torch.float32
    Bh = torch.repeat_interleave(B_t, rep, dim=1)     # (B,H,N)
    Ch = torch.repeat_interleave(C_t, rep, dim=1)
    dA = torch.exp(dt_t.to(f32) * A)                  # (B,H)
    upd = torch.einsum("bhp,bhn->bhpn",
                       (x_t * dt_t[..., None]).to(f32), Bh.to(f32))
    new_state = state * dA[..., None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch.to(f32))
    return new_state, y.to(x_t.dtype)


# ---------------------------------------------------------------------------
# Full block
# ---------------------------------------------------------------------------
def _gated_rmsnorm(x: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    xf = (x * F.silu(z.to(torch.float32)).to(x.dtype)).to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def apply_mamba2(p: Dict, x: torch.Tensor, cfg: ArchConfig,
                 state: Optional[Dict] = None,
                 use_kernel: Optional[bool] = None
                 ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B,S,d).  state (decode): {"ssm": (B,H,P,N), "conv": (B,K-1,Cd)}.

    Prefill: state=None, the chunked scan through
    ``ops.ssd_scan_heads`` (the kernel on the kernel path, see
    ``ops.resolve_use_kernel``), returns (y, None).
    Decode: S==1, returns (y, new_state); the new conv state is the
    concatenation of the old one's tail and this token's inputs, in the
    promoted dtype of the two, as in the reference.
    """
    from repro_torch.kernels import ops as kernel_ops
    dm = dims(cfg)
    H, P, N, G = dm["H"], dm["P"], dm["N"], dm["G"]
    Bsz, S, _ = x.shape
    dt_ = x.dtype

    zxbcdt = x @ p["w_in"]
    z, xin, Bc, Cc, dt_raw = _split_proj(zxbcdt, cfg)
    conv_in = torch.cat([xin, Bc, Cc], dim=-1)
    A = -torch.exp(p["A_log"])

    if state is None:
        conv_out = F.silu(causal_conv1d(conv_in, p["conv_w"], p["conv_b"]))
        xin, Bc, Cc = torch.split(conv_out, [dm["d_inner"], G * N, G * N],
                                  dim=-1)
        dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"])
        xh = xin.reshape(Bsz, S, H, P)
        y = kernel_ops.ssd_scan_heads(xh, dt, A, Bc.reshape(Bsz, S, G, N),
                                      Cc.reshape(Bsz, S, G, N),
                                      chunk=_cfg(cfg).chunk_size,
                                      use_kernel=use_kernel)
        y = y + xh * p["D"].to(dt_)[None, None, :, None]
        y = y.reshape(Bsz, S, dm["d_inner"])
        y = _gated_rmsnorm(y, z, p["norm_scale"])
        return y @ p["w_out"], None

    # ---- decode: one token ------------------------------------------------
    assert S == 1
    conv_state = state["conv"]                        # (B, K-1, Cd)
    conv_out = causal_conv1d(conv_in, p["conv_w"], p["conv_b"],
                             state=conv_state)
    new_conv = torch.cat([conv_state[:, 1:], conv_in], dim=1)
    conv_out = F.silu(conv_out)
    xin, Bc, Cc = torch.split(conv_out, [dm["d_inner"], G * N, G * N],
                              dim=-1)
    dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"])
    new_ssm, y = ssd_decode_step(
        state["ssm"], xin.reshape(Bsz, H, P), dt.reshape(Bsz, H), A,
        Bc.reshape(Bsz, G, N), Cc.reshape(Bsz, G, N))
    y = y + xin.reshape(Bsz, H, P) * p["D"].to(dt_)[None, :, None]
    y = y.reshape(Bsz, 1, dm["d_inner"])
    y = _gated_rmsnorm(y, z, p["norm_scale"])
    return y @ p["w_out"], {"ssm": new_ssm, "conv": new_conv}


def init_mamba2_state(cfg: ArchConfig, batch: int, *, lead=(),
                      device) -> Dict[str, torch.Tensor]:
    """Zero decode state, with ``lead`` stacking axes in front: the SSM
    state in float32 and the conv state in bfloat16, as the reference
    (a float32 step promotes it on its first update)."""
    dm = dims(cfg)
    conv_dim = dm["d_inner"] + 2 * dm["G"] * dm["N"]
    lead = tuple(lead)
    return {
        "ssm": torch.zeros(lead + (batch, dm["H"], dm["P"], dm["N"]),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros(lead + (batch, dm["K"] - 1, conv_dim),
                            dtype=torch.bfloat16, device=device),
    }
