"""xLSTM blocks [arXiv:2405.04517]: mLSTM (matrix memory, chunkwise
parallel) and sLSTM (scalar memory with recurrent gate connections,
sequential).

The counterpart of ``repro/models/xlstm.py``.  :func:`mlstm_chunkwise` is
the stabilized chunkwise form in plain PyTorch, the plain version of the
mLSTM kernel (``kernels/mlstm_scan.py``); :func:`apply_mlstm_block`'s
prefill branch goes through ``kernels.ops.mlstm_scan_heads``, which runs
the kernel on CUDA tensors and :func:`mlstm_chunkwise` on CPU tensors.
The recurrent step form serves decode.  sLSTM's recurrent weights act on
h_{t-1}, so :func:`slstm_scan` stays a plain loop over time, as in the
reference.  ``w_if``, ``b_i``, ``b_f``, ``w_gates``, ``b_gates`` and
``r_gates`` stay float32, which the reference reads in float32
arithmetic (``common.keeps_float32``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, XLSTMConfig
from repro_torch.models.common import (apply_norm, dense_init_, fan_in_std,
                                       norm_params)
from repro_torch.models.ssm import causal_conv1d


def _x(cfg: ArchConfig) -> XLSTMConfig:
    assert cfg.xlstm is not None
    return cfg.xlstm


def mlstm_dims(cfg: ArchConfig) -> Dict[str, int]:
    d_in = int(cfg.d_model * _x(cfg).mlstm_proj_factor)
    H = cfg.n_heads
    return dict(d_in=d_in, H=H, hd=d_in // H)


def _stacked(n: int, shape, g: torch.Generator, std: float, *, device,
             dtype: torch.dtype) -> torch.Tensor:
    """``n`` truncated-normal matrices of ``shape`` and ``std``."""
    out = torch.empty((n,) + tuple(shape), dtype=dtype, device=device)
    for l in range(n):
        dense_init_(out[l], g, std=std)
    return out


# ---------------------------------------------------------------------------
# mLSTM block (pre-up-projection)
# ---------------------------------------------------------------------------
def mlstm_params(cfg: ArchConfig, n: int, g: torch.Generator, *, device,
                 dtype: torch.dtype) -> Dict:
    """``n`` stacked mLSTM blocks with the reference's distributions; the
    forget-gate bias is linspace(3, 6) over the heads (long memory at
    init)."""
    d = cfg.d_model
    dm = mlstm_dims(cfg)
    d_in, H = dm["d_in"], dm["H"]
    K = _x(cfg).conv1d_kernel
    kw = dict(device=device, dtype=dtype)
    f32 = dict(device=device, dtype=torch.float32)
    conv_w = torch.empty((n, K, d_in), **kw)
    for l in range(n):
        conv_w[l].copy_(torch.randn((K, d_in), generator=g, **f32)
                        / (K * d_in) ** 0.5)
    return {
        "norm": norm_params(cfg.norm_type, d, True, n=n, device=device),
        "w_up": _stacked(n, (d, d_in), g, fan_in_std((d,)), **kw),
        "w_z": _stacked(n, (d, d_in), g, fan_in_std((d,)), **kw),
        "conv_w": conv_w,
        "conv_b": torch.zeros((n, d_in), **kw),
        "wq": _stacked(n, (d_in, d_in), g, fan_in_std((d_in,)), **kw),
        "wk": _stacked(n, (d_in, d_in), g, fan_in_std((d_in,)), **kw),
        "wv": _stacked(n, (d_in, d_in), g, fan_in_std((d_in,)), **kw),
        "w_if": _stacked(n, (d_in, 2 * H), g,
                         fan_in_std((d_in,), scale=0.1), **f32),
        "b_i": torch.zeros((n, H), **f32),
        "b_f": torch.linspace(3.0, 6.0, H, **f32).repeat(n, 1),
        "out_norm_scale": torch.ones((n, d_in), **f32),
        "w_down": _stacked(n, (d_in, d), g, fan_in_std((d_in,)), **kw),
    }


def mlstm_chunkwise(q, k, v, log_i, log_f, chunk: int,
                    state: Optional[Tuple] = None):
    """Stabilized chunkwise mLSTM, with the reference's roundings: the
    intra-chunk weights and the carried C meet q, k, v in q's dtype.

    q,k,v: (B, L, H, hd); log_i/log_f: (B, L, H) float32.
    Returns (h (B,L,H,hd), (C (B,H,hd,hd), n (B,H,hd), m (B,H))).
    """
    B, L, H, hd = q.shape
    Q = min(chunk, L)
    if L % Q:
        raise ValueError(f"sequence {L} is not a multiple of chunk {Q}")
    nc = L // Q
    scale = 1.0 / (hd ** 0.5)
    f32 = torch.float32
    dev = q.device

    qr = (q * scale).reshape(B, nc, Q, H, hd)
    kr = k.reshape(B, nc, Q, H, hd)
    vr = v.reshape(B, nc, Q, H, hd)
    lir = log_i.reshape(B, nc, Q, H)
    lfr = log_f.reshape(B, nc, Q, H)
    b = torch.cumsum(lfr, dim=2)                      # inclusive cumsum
    bQ = b[:, :, -1, :]                               # (B,nc,H)

    # intra-chunk log weights: w[t,j] = b_t - b_j + li_j  (j <= t)
    wmat = (b[:, :, :, None, :] - b[:, :, None, :, :]
            + lir[:, :, None, :, :])                  # (B,nc,Qt,Qj,H)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=dev))
    wmat = torch.where(tri[None, None, :, :, None], wmat,
                       torch.tensor(float("-inf"), dtype=wmat.dtype,
                                    device=dev))
    w_max = wmat.amax(dim=3)                          # (B,nc,Qt,H)

    if state is None:
        C = torch.zeros((B, H, hd, hd), dtype=f32, device=dev)
        n = torch.zeros((B, H, hd), dtype=f32, device=dev)
        m = torch.full((B, H), float("-inf"), dtype=f32, device=dev)
    else:
        C, n, m = state

    hs = []
    for c in range(nc):
        q_c, k_c, v_c = qr[:, c], kr[:, c], vr[:, c]
        li_c, b_c, bQ_c = lir[:, c], b[:, c], bQ[:, c]
        # per-position stabilizer
        m_pos = torch.maximum(w_max[:, c], b_c + m[:, None, :])  # (B,Q,H)

        # intra-chunk
        s = torch.einsum("bqhd,bjhd->bqjh", q_c, k_c).to(f32)
        D = torch.exp(wmat[:, c] - m_pos[:, :, None, :])
        S = s * D
        num_intra = torch.einsum("bqjh,bjhd->bqhd", S.to(q.dtype), v_c)
        den_intra = S.sum(dim=2)                      # (B,Q,H)

        # inter-chunk (carried state)
        inter_w = torch.exp(b_c + m[:, None, :] - m_pos)          # (B,Q,H)
        num_inter = torch.einsum("bqhd,bhde->bqhe", q_c, C.to(q.dtype))
        num_inter = num_inter * inter_w[..., None].to(q.dtype)
        den_inter = torch.einsum("bqhd,bhd->bqh", q_c.to(f32),
                                 n) * inter_w

        num = num_intra.to(f32) + num_inter.to(f32)
        den = den_intra + den_inter
        denom = torch.maximum(torch.abs(den), torch.exp(-m_pos))
        hs.append((num / denom[..., None]).to(q.dtype))

        # state update
        upd_w = bQ_c[:, None, :] - b_c + li_c                     # (B,Q,H)
        m_new = torch.maximum(bQ_c + m, upd_w.amax(dim=1))        # (B,H)
        k_scaled = k_c.to(f32) * torch.exp(
            upd_w - m_new[:, None, :])[..., None]
        decay = torch.exp(bQ_c + m - m_new)
        C = (C * decay[..., None, None]
             + torch.einsum("bqhd,bqhe->bhde", k_scaled, v_c.to(f32)))
        n = n * decay[..., None] + k_scaled.sum(dim=1)
        m = m_new
    h = torch.stack(hs, dim=1).reshape(B, L, H, hd)
    return h, (C, n, m)


def mlstm_decode_step(state, q, k, v, log_i, log_f):
    """One step.  state (C,n,m); q/k/v (B,H,hd); gates (B,H) float32."""
    C_prev, n_prev, m_prev = state
    f32 = torch.float32
    hd = q.shape[-1]
    q = q * (1.0 / hd ** 0.5)
    m_new = torch.maximum(log_f + m_prev, log_i)
    f_eff = torch.exp(log_f + m_prev - m_new)
    i_eff = torch.exp(log_i - m_new)
    kf = k.to(f32) * i_eff[..., None]
    C_new = C_prev * f_eff[..., None, None] + torch.einsum(
        "bhd,bhe->bhde", kf, v.to(f32))
    n_new = n_prev * f_eff[..., None] + kf
    num = torch.einsum("bhd,bhde->bhe", q.to(f32), C_new)
    den = torch.einsum("bhd,bhd->bh", q.to(f32), n_new)
    denom = torch.maximum(torch.abs(den), torch.exp(-m_new))
    h = (num / denom[..., None]).to(q.dtype)
    return (C_new, n_new, m_new), h


def _multihead_rmsnorm(x: torch.Tensor, scale: torch.Tensor, H: int,
                       eps: float = 1e-6) -> torch.Tensor:
    """Head-wise RMSNorm over (B,S,H,hd) with a flattened (d_in,) scale."""
    B, S, d_in = x.shape
    hd = d_in // H
    xf = x.to(torch.float32).reshape(B, S, H, hd)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(var + eps)).reshape(B, S, d_in) * scale
    return out.to(x.dtype)


def apply_mlstm_block(p: Dict, x: torch.Tensor, cfg: ArchConfig,
                      state: Optional[Dict] = None, chunk: int = 128,
                      use_kernel: Optional[bool] = None
                      ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Residual mLSTM block.  x (B,S,d).  Prefill (state=None) runs the
    chunkwise form through ``ops.mlstm_scan_heads``; decode (S == 1)
    the recurrent step, returning the new state."""
    from repro_torch.kernels import ops as kernel_ops
    dm = mlstm_dims(cfg)
    d_in, H, hd = dm["d_in"], dm["H"], dm["hd"]
    B, S, _ = x.shape

    xn = apply_norm(cfg.norm_type, p["norm"], x)
    x_up = xn @ p["w_up"]
    z_up = xn @ p["w_z"]

    if state is None:
        conv = F.silu(causal_conv1d(x_up, p["conv_w"], p["conv_b"]))
        new_conv = None
    else:
        conv = F.silu(causal_conv1d(x_up, p["conv_w"], p["conv_b"],
                                    state=state["conv"]))
        new_conv = torch.cat([state["conv"][:, 1:], x_up], dim=1)

    q = (conv @ p["wq"]).reshape(B, S, H, hd)
    k = (conv @ p["wk"]).reshape(B, S, H, hd)
    v = (x_up @ p["wv"]).reshape(B, S, H, hd)
    gates = x_up.to(torch.float32) @ p["w_if"].to(torch.float32)
    log_i = gates[..., :H] + p["b_i"]
    log_f = F.logsigmoid(gates[..., H:] + p["b_f"])

    if state is None:
        h = kernel_ops.mlstm_scan_heads(q, k, v, log_i, log_f, chunk=chunk,
                                        use_kernel=use_kernel)
        new_state = None
    else:
        assert S == 1
        (C, n, m), h = mlstm_decode_step(
            (state["C"], state["n"], state["m"]),
            q[:, 0], k[:, 0], v[:, 0], log_i[:, 0], log_f[:, 0])
        h = h[:, None]
        new_state = {"C": C, "n": n, "m": m, "conv": new_conv}

    h = h.reshape(B, S, d_in)
    h = _multihead_rmsnorm(h, p["out_norm_scale"], H)
    h = h * F.silu(z_up)
    return x + h @ p["w_down"], new_state


def init_mlstm_state(cfg: ArchConfig, batch: int, *, lead=(),
                     device) -> Dict[str, torch.Tensor]:
    """Zero decode state with ``lead`` stacking axes in front; m starts at
    the reference's finite -1e30 and the conv state in bfloat16."""
    dm = mlstm_dims(cfg)
    K = _x(cfg).conv1d_kernel
    lead = tuple(lead)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "C": torch.zeros(lead + (batch, dm["H"], dm["hd"], dm["hd"]), **f32),
        "n": torch.zeros(lead + (batch, dm["H"], dm["hd"]), **f32),
        "m": torch.full(lead + (batch, dm["H"]), -1e30, **f32),
        "conv": torch.zeros(lead + (batch, K - 1, dm["d_in"]),
                            dtype=torch.bfloat16, device=device),
    }


# ---------------------------------------------------------------------------
# sLSTM block (post-up-projection): sequential scan
# ---------------------------------------------------------------------------
def slstm_params(cfg: ArchConfig, n: int, g: torch.Generator, *, device,
                 dtype: torch.dtype) -> Dict:
    """``n`` stacked sLSTM blocks; the gate weights and biases float32,
    the forget-gate bias linspace(3, 6) over d."""
    d, H = cfg.d_model, cfg.n_heads
    hd = d // H
    ff = int(d * _x(cfg).slstm_proj_factor)
    kw = dict(device=device, dtype=dtype)
    f32 = dict(device=device, dtype=torch.float32)
    b_gates = torch.cat([torch.zeros(d, **f32),
                         torch.linspace(3.0, 6.0, d, **f32),
                         torch.zeros(2 * d, **f32)])
    return {
        "norm": norm_params(cfg.norm_type, d, True, n=n, device=device),
        # input weights for 4 gates (i, f, z, o)
        "w_gates": _stacked(n, (d, 4 * d), g, fan_in_std((d,)), **f32),
        # block-diagonal recurrent weights per head, per gate
        "r_gates": _stacked(n, (4, H, hd, hd), g,
                            fan_in_std((4, H, hd, hd), in_axis=2,
                                       scale=0.5), **f32),
        "b_gates": b_gates.repeat(n, 1),
        "out_norm": norm_params(cfg.norm_type, d, True, n=n, device=device),
        # gated FFN (proj factor ~4/3)
        "ffn_norm": norm_params(cfg.norm_type, d, True, n=n, device=device),
        "ffn_gate": _stacked(n, (d, ff), g, fan_in_std((d,)), **kw),
        "ffn_up": _stacked(n, (d, ff), g, fan_in_std((d,)), **kw),
        "ffn_down": _stacked(n, (ff, d), g, fan_in_std((ff,)), **kw),
    }


def slstm_scan(p: Dict, xn: torch.Tensor, H: int,
               state: Optional[Tuple] = None):
    """xn: (B,S,d) pre-normed input.  Sequential over S.

    Returns (h (B,S,d), final_state (c, n, m, h_prev) each (B,d) float32)."""
    B, S, d = xn.shape
    hd = d // H
    f32 = torch.float32
    gates_in = (xn.to(f32) @ p["w_gates"].to(f32) + p["b_gates"])  # (B,S,4d)

    if state is None:
        c = torch.zeros((B, d), dtype=f32, device=xn.device)
        n = torch.ones((B, d), dtype=f32, device=xn.device)
        m = torch.zeros((B, d), dtype=f32, device=xn.device)
        h = torch.zeros((B, d), dtype=f32, device=xn.device)
    else:
        c, n, m, h = state

    r = p["r_gates"].to(f32)                          # (4,H,hd,hd)
    hs = []
    for t in range(S):
        g_t = gates_in[:, t]
        rec = torch.einsum("bhd,ghde->gbhe", h.reshape(B, H, hd),
                           r).reshape(4, B, d)
        gi = g_t[..., :d] + rec[0]
        gf = g_t[..., d:2 * d] + rec[1]
        gz = g_t[..., 2 * d:3 * d] + rec[2]
        go = g_t[..., 3 * d:] + rec[3]
        log_f = F.logsigmoid(gf)
        m_new = torch.maximum(log_f + m, gi)
        i_eff = torch.exp(gi - m_new)
        f_eff = torch.exp(log_f + m - m_new)
        c = f_eff * c + i_eff * torch.tanh(gz)
        n = f_eff * n + i_eff
        h = torch.sigmoid(go) * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1), (c, n, m, h)


def apply_slstm_block(p: Dict, x: torch.Tensor, cfg: ArchConfig,
                      state: Optional[Dict] = None
                      ) -> Tuple[torch.Tensor, Optional[Dict]]:
    H = cfg.n_heads
    dt = x.dtype
    xn = apply_norm(cfg.norm_type, p["norm"], x)
    if state is None:
        h, _ = slstm_scan(p, xn, H)
        new_state = None
    else:
        h, (c, n, m, hf) = slstm_scan(
            p, xn, H, state=(state["c"], state["n"], state["m"], state["h"]))
        new_state = {"c": c, "n": n, "m": m, "h": hf}
    h = apply_norm(cfg.norm_type, p["out_norm"], h.to(dt))
    x = x + h
    # gated FFN
    xf = apply_norm(cfg.norm_type, p["ffn_norm"], x)
    gt = F.gelu(xf @ p["ffn_gate"], approximate="tanh")
    u = xf @ p["ffn_up"]
    return x + (gt * u) @ p["ffn_down"], new_state


def init_slstm_state(cfg: ArchConfig, batch: int, *, lead=(),
                     device) -> Dict[str, torch.Tensor]:
    """Zero sLSTM decode state (n starts at ones), float32."""
    shape = tuple(lead) + (batch, cfg.d_model)
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros(shape, **f32), "n": torch.ones(shape, **f32),
            "m": torch.zeros(shape, **f32), "h": torch.zeros(shape, **f32)}
