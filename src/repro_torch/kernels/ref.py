"""Plain PyTorch versions of the port's kernels: flash attention (forward,
forward with logsumexp, backward), paged attention, the SSD scan's
sequential oracle and the pseudo-Voigt Bragg-peak fit.

Each function is the mathematical specification its CUDA kernel must
match; the port's tests hold it to the reference package's own oracle
(``repro/kernels/ref.py``) on the same inputs, and ``chip_smoke.py`` holds
the kernel to it on the card.  It is also the serving path for CPU
tensors (``kernels/ops.py`` dispatches here by device).

The flash-attention versions compute in float32 from any input dtype, as
the reference's ``attention_reference`` and ``_flash_bwd`` do.  For the
paged reads, dtype choices copy the reference: scores are contracted in
the input dtype and then cast to float32, and the softmax weights are
cast back to ``q.dtype`` before the PV contraction.  Where the reference lets jnp
promote mixed dtypes (an int8 pool dequantized to float32 against a bf16
query), the port promotes explicitly, since torch contractions refuse
mixed operands; the result is returned in ``q.dtype``, as the kernel
writes it.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30

# rows of the (5, n_tiles) int32 tile metadata shared by the kernel, this
# oracle and serving.batch.TileMap
TILE_WINDOW, TILE_LO, TILE_HI, TILE_POS0, TILE_LANE = range(5)


# ---------------------------------------------------------------------------
# flash attention: the forward (B6), the forward with logsumexp (B6f) and
# the backward (B6b), all on (B, H, S, D) q and (B, Hkv, S, D) k/v
# ---------------------------------------------------------------------------
def _band_mask(S: int, causal: bool, window: int,
               device: torch.device) -> torch.Tensor:
    """(S, S) bool: key ``s`` is visible to query ``q``."""
    qpos = torch.arange(S, device=device)[:, None]
    kpos = torch.arange(S, device=device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= (qpos - kpos) < window
    return mask


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, window: int, with_lse: bool):
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    qg = q.reshape(B, Hkv, H // Hkv, S, D).to(torch.float32)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.to(torch.float32))
    s = s / (D ** 0.5)
    s = torch.where(_band_mask(S, causal, window, q.device), s,
                    torch.tensor(NEG_INF, dtype=s.dtype, device=s.device))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", w, v.to(torch.float32))
    out = out.reshape(B, H, S, D).to(q.dtype)
    if not with_lse:
        return out
    return out, torch.logsumexp(s, dim=-1).reshape(B, H, S)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0
                        ) -> torch.Tensor:
    """q (B, H, S, D), k/v (B, Hkv, S, D) -> (B, H, S, D) in ``q.dtype``:
    plain masked softmax in float32, query head h reading kv head
    ``h // (H // Hkv)``.  The plain version of B6."""
    return _attend(q, k, v, causal, window, False)


def attention_lse_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`attention_reference` and the logsumexp of every query's
    masked scores, (B, H, S) float32.  The plain version of B6f."""
    return _attend(q, k, v, causal, window, True)


def attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor, *,
                            causal: bool = True, window: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """(dq, dk, dv) of attention from the forward's output ``o`` and
    logsumexp ``lse`` and the output's gradient ``do``, in the dtypes of
    q, k and v: the arithmetic of the reference's ``_flash_bwd`` (all in
    float32; ``delta = sum(do * o)`` per query; scores scaled after the
    contraction; ``p = exp(s - lse)`` inside the mask, else 0;
    ``ds = p * (dp - delta) * scale``), with dk and dv summed over the G
    query heads of each kv head.  The plain version of B6b.  One kv head
    at a time, so the (B, G, S, S) intermediates bound its memory."""
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    scale = 1.0 / (D ** 0.5)
    f32 = torch.float32
    delta = (do.to(f32) * o.to(f32)).sum(dim=-1)              # (B, H, S)
    mask = _band_mask(S, causal, window, q.device)
    dq = torch.empty(q.shape, dtype=f32, device=q.device)
    dk = torch.empty(k.shape, dtype=f32, device=q.device)
    dv = torch.empty(v.shape, dtype=f32, device=q.device)
    for kh in range(Hkv):
        hs = slice(kh * G, (kh + 1) * G)
        qh, doh = q[:, hs].to(f32), do[:, hs].to(f32)         # (B, G, S, D)
        kk, vv = k[:, kh].to(f32), v[:, kh].to(f32)           # (B, S, D)
        s = torch.einsum("bgqd,bsd->bgqs", qh, kk) * scale
        p = torch.where(mask, torch.exp(s - lse[:, hs, :, None]), 0.0)
        dp = torch.einsum("bgqd,bsd->bgqs", doh, vv)
        ds = p * (dp - delta[:, hs, :, None]) * scale
        dq[:, hs] = torch.einsum("bgqs,bsd->bgqd", ds, kk)
        dk[:, kh] = torch.einsum("bgqs,bgqd->bsd", ds, qh)
        dv[:, kh] = torch.einsum("bgqs,bgqd->bsd", p, doh)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _apply_block_scales(spans: torch.Tensor, scale_pool: torch.Tensor,
                        tables: torch.Tensor) -> torch.Tensor:
    """Dequantize gathered int8 KV spans (rows, S, Hkv, D) with the scale
    spans gathered through the same block tables."""
    rows = tables.shape[0]
    sc = scale_pool[tables].reshape(rows, -1, scale_pool.shape[2])
    return spans.to(torch.float32) * sc[..., None]


def _gather_block_spans(pool: torch.Tensor,
                        tables: torch.Tensor) -> torch.Tensor:
    """Row r of the result is the gathered span ``pool[tables[r]]``
    flattened to (rows, max_blocks * bs, Hkv, D)."""
    rows, max_blocks = tables.shape
    _, bs, Hkv, D = pool.shape
    return pool[tables].reshape(rows, max_blocks * bs, Hkv, D)


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with jnp's type promotion for mixed operands."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def _masked_attention(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      valid: torch.Tensor, eq_s: str, eq_o: str
                      ) -> torch.Tensor:
    """Scores of ``qg`` against gathered spans ``k`` by ``eq_s`` in the
    input dtype, cast to float32 and scaled, masked to -1e30 outside
    ``valid`` (broadcast against the scores), softmax, weights cast back
    to ``qg.dtype``, then ``eq_o`` against ``v`` -- the reference's
    dtype choices."""
    s = _einsum(eq_s, qg, k).to(torch.float32) / (qg.shape[-1] ** 0.5)
    s = torch.where(valid, s, torch.tensor(NEG_INF, dtype=s.dtype,
                                           device=s.device))
    w = torch.softmax(s, dim=-1).to(qg.dtype)
    return _einsum(eq_o, w, v)


def paged_attention_chunk_reference(
        q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
        block_tables: torch.Tensor, q_starts: torch.Tensor, *,
        window: int = 0, k_scale: Optional[torch.Tensor] = None,
        v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, C, H, D), a chunk of C query tokens per lane, token c at
    absolute position ``q_starts[b] + c``; ``block_tables`` (B,
    max_blocks).  Returns (B, C, H, D) in ``q.dtype``.

    Logical kv position t of lane b lives in block ``block_tables[b, t //
    bs]`` at offset ``t % bs``; query c masks kv positions past
    ``q_starts[b] + c`` (and outside the sliding window), so causality
    holds inside the chunk.  Padded queries give finite values that
    callers ignore."""
    B, C, H, D = q.shape
    Hkv = k_pool.shape[2]
    tables = block_tables.long()
    k = _gather_block_spans(k_pool, tables)           # (B, S, Hkv, D)
    v = _gather_block_spans(v_pool, tables)
    if k_scale is not None:
        k = _apply_block_scales(k, k_scale, tables)
        v = _apply_block_scales(v, v_scale, tables)
    qpos = q_starts.long()[:, None] + torch.arange(C, device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)[None, None, :]
    valid = kpos <= qpos[:, :, None]                   # (B, C, S)
    if window:
        valid &= (qpos[:, :, None] - kpos) < window
    out = _masked_attention(q.reshape(B, C, Hkv, H // Hkv, D), k, v,
                            valid[:, :, None, None, :],
                            "bckgd,bskd->bckgs", "bckgs,bskd->bckgd")
    return out.reshape(B, C, H, D).to(q.dtype)


def paged_attention_reference(
        q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
        block_tables: torch.Tensor, ctx_lens: torch.Tensor, *,
        window: int = 0, k_scale: Optional[torch.Tensor] = None,
        v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, H, D), one query token per lane at position ``ctx_lens - 1``:
    the decode case of :func:`paged_attention_chunk_reference`.  Returns
    (B, H, D) in ``q.dtype``."""
    return paged_attention_chunk_reference(
        q[:, None], k_pool, v_pool, block_tables, ctx_lens - 1,
        window=window, k_scale=k_scale, v_scale=v_scale)[:, 0]


def paged_attention_ragged_reference(
        q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
        token_tables: torch.Tensor, token_pos: torch.Tensor, *,
        window: int = 0, k_scale: Optional[torch.Tensor] = None,
        v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (T, H, D), one flat stream of query tokens from many lanes;
    ``token_tables`` (T, max_blocks), row t the block-table row of token
    t's lane; ``token_pos`` (T,) its absolute position.  Returns (T, H, D)
    in ``q.dtype``.

    Token t attends to kv positions ``<= token_pos[t]`` of its own lane's
    blocks (and inside the sliding window), one span gather per token.
    Padding tokens (zero tables, position 0) give finite values that
    callers ignore."""
    T, H, D = q.shape
    Hkv = k_pool.shape[2]
    tables = token_tables.long()
    k = _gather_block_spans(k_pool, tables)           # (T, S, Hkv, D)
    v = _gather_block_spans(v_pool, tables)
    if k_scale is not None:
        k = _apply_block_scales(k, k_scale, tables)
        v = _apply_block_scales(v, v_scale, tables)
    pos = token_pos.long()[:, None]
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]
    valid = kpos <= pos                                # (T, S)
    if window:
        valid &= (pos - kpos) < window
    out = _masked_attention(q.reshape(T, Hkv, H // Hkv, D), k, v,
                            valid[:, None, None, :],
                            "tkgd,tskd->tkgs", "tkgs,tskd->tkgd")
    return out.reshape(T, H, D).to(q.dtype)


def paged_attention_ragged_tiled_reference(
        q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
        tables: torch.Tensor, tile_meta: torch.Tensor,
        row_tile: torch.Tensor, *, tile: int, window: int = 0,
        k_scale: Optional[torch.Tensor] = None,
        v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (T, H, D) flat token stream attended through the segment-tiled
    metadata: ``tables`` (n_lanes, max_blocks) per-lane block rows,
    ``tile_meta`` (5, n_tiles) int32 (``TILE_*`` rows), ``row_tile`` (T,)
    the owning tile of every flat row.  Returns (T, H, D) in ``q.dtype``.

    Each lane's KV span is gathered once; tile t attends its q rows
    ``[lo, hi)`` against its lane's span with the causal bound
    ``pos0 + (row - lo)`` (and the sliding window).  Rows outside the
    tile's span are masked; inert tiles (lo == hi) and stream-padding rows
    give finite values that callers ignore.
    """
    T, H, D = q.shape
    _, bs, Hkv, _ = k_pool.shape
    G = H // Hkv
    tables = tables.long()
    meta = tile_meta.long()
    S = tables.shape[1] * bs
    n_windows = -(-T // tile)
    pad = n_windows * tile - T
    qw = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad))
    qw = qw.reshape(n_windows, tile, Hkv, G, D)
    k_lanes = _gather_block_spans(k_pool, tables)      # (n_lanes, S, Hkv, D)
    v_lanes = _gather_block_spans(v_pool, tables)
    if k_scale is not None:
        k_lanes = _apply_block_scales(k_lanes, k_scale, tables)
        v_lanes = _apply_block_scales(v_lanes, v_scale, tables)
    win, lo, hi = meta[TILE_WINDOW], meta[TILE_LO], meta[TILE_HI]
    pos0, lane = meta[TILE_POS0], meta[TILE_LANE]
    qt = qw[win]                                   # (n_tiles, tile, Hkv, G, D)
    kt = k_lanes[lane]                             # (n_tiles, S, Hkv, D)
    vt = v_lanes[lane]
    dev = q.device
    rows = win[:, None] * tile + torch.arange(tile, device=dev)[None, :]
    qpos = pos0[:, None] + rows - lo[:, None]
    rowvalid = (rows >= lo[:, None]) & (rows < hi[:, None])
    kpos = torch.arange(S, device=dev)[None, None, :]
    valid = rowvalid[:, :, None] & (kpos <= qpos[:, :, None])
    if window:
        valid &= (qpos[:, :, None] - kpos) < window
    ot = _masked_attention(qt, kt, vt, valid[:, :, None, None, :],
                           "ntkgd,nskd->ntkgs",
                           "ntkgs,nskd->ntkgd")   # (n_tiles, tile, Hkv, G, D)
    r = torch.arange(T, device=dev)
    t_idx = row_tile[:T].long()
    off = torch.clamp(r - win[t_idx] * tile, 0, tile - 1)
    return ot[t_idx, off].reshape(T, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# ssd_scan oracle: the direct (non-chunked) linear recurrence
# ---------------------------------------------------------------------------
def ssd_reference(xdt: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor,
                  Cm: torch.Tensor) -> torch.Tensor:
    """Sequential SSM recurrence, the ground truth for the chunked forms
    (the SSD kernel and ``models/ssm.py::ssd_chunked``).

    xdt: (B,H,L,P); dA: (B,H,L); Bm/Cm: (B,G,L,N) -> y (B,H,L,P) in xdt's
    dtype, computed in float32:
    h_t = exp(dA_t) h_{t-1} + xdt_t B_t^T ;  y_t = h_t C_t
    """
    B, H, L, P = xdt.shape
    G, N = Bm.shape[1], Bm.shape[3]
    rep = H // G
    Bh = torch.repeat_interleave(Bm, rep, dim=1).to(torch.float32)
    Ch = torch.repeat_interleave(Cm, rep, dim=1).to(torch.float32)
    x = xdt.to(torch.float32)
    decay = torch.exp(dA.to(torch.float32))
    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=xdt.device)
    ys = []
    for t in range(L):
        h = h * decay[:, :, t, None, None] + torch.einsum(
            "bhp,bhn->bhpn", x[:, :, t], Bh[:, :, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, :, t]))
    return torch.stack(ys, dim=2).to(xdt.dtype)


# ---------------------------------------------------------------------------
# pseudo-Voigt: the separable marginal Gauss-Newton fit
# ---------------------------------------------------------------------------
_ETA = 0.5                                   # fixed Lorentzian fraction
_C = 1.0 / math.sqrt(2.0 * math.log(2.0))    # sigma = _C * gamma


def pv_profile(u: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """Unit-amplitude pseudo-Voigt profile at offsets u."""
    g2 = gamma * gamma
    lor = g2 / (u * u + g2)
    sig = _C * gamma
    gau = torch.exp(-(u * u) / (2.0 * sig * sig))
    return _ETA * lor + (1.0 - _ETA) * gau


def _pv_grads(u: torch.Tensor, gamma: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The profile and its derivatives by the center and by gamma."""
    g2 = gamma * gamma
    lor = g2 / (u * u + g2)
    sig = _C * gamma
    gau = torch.exp(-(u * u) / (2.0 * sig * sig))
    d_lor_dx0 = 2.0 * u * lor * lor / g2
    d_gau_dx0 = gau * u / (sig * sig)
    d_lor_dg = 2.0 * u * u * lor * lor / (g2 * gamma)
    d_gau_dg = gau * u * u / (_C * _C * gamma ** 3)
    dp_dx0 = _ETA * d_lor_dx0 + (1 - _ETA) * d_gau_dx0
    dp_dg = _ETA * d_lor_dg + (1 - _ETA) * d_gau_dg
    p = _ETA * lor + (1 - _ETA) * gau
    return p, dp_dx0, dp_dg


def pv_fit_1d(y: torch.Tensor, n_iter: int = 5
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fit A * pV(x - x0; gamma) + bg to y (..., n) by Gauss-Newton.

    Returns (x0, gamma, A).  bg is the per-profile min (subtracted, not
    fit).  Each step solves the regularised 3x3 normal equations in
    closed form; a determinant below 1e-20 in magnitude is replaced by
    +1e-20, and A, x0 and gamma are clamped to [1e-12, inf), [0, n - 1]
    and [0.3, n].
    """
    n = y.shape[-1]
    x = torch.arange(n, dtype=torch.float32, device=y.device)
    yf = y.to(torch.float32)
    bg = yf.amin(dim=-1, keepdim=True)
    yc = yf - bg
    total = torch.clamp(yc.sum(dim=-1), min=1e-12)

    x0 = (yc * x).sum(dim=-1) / total
    var = (yc * (x - x0[..., None]) ** 2).sum(dim=-1) / total
    gamma = torch.sqrt(torch.clamp(var, min=0.25))
    A = torch.clamp(yc.amax(dim=-1), min=1e-12)

    for _ in range(n_iter):
        u = x - x0[..., None]
        p, dp_dx0, dp_dg = _pv_grads(u, gamma[..., None])
        r = yc - A[..., None] * p
        # jacobian columns: dA, dx0, dgamma
        j0 = p
        j1 = A[..., None] * dp_dx0
        j2 = A[..., None] * dp_dg
        a00 = (j0 * j0).sum(-1); a01 = (j0 * j1).sum(-1); a02 = (j0 * j2).sum(-1)
        a11 = (j1 * j1).sum(-1); a12 = (j1 * j2).sum(-1); a22 = (j2 * j2).sum(-1)
        b0 = (j0 * r).sum(-1); b1 = (j1 * r).sum(-1); b2 = (j2 * r).sum(-1)
        lam = 1e-6 * (a00 + a11 + a22) + 1e-12
        a00 = a00 + lam; a11 = a11 + lam; a22 = a22 + lam
        det = (a00 * (a11 * a22 - a12 * a12)
               - a01 * (a01 * a22 - a12 * a02)
               + a02 * (a01 * a12 - a11 * a02))
        det = torch.where(det.abs() < 1e-20, 1e-20, det)
        i00 = a11 * a22 - a12 * a12
        i01 = a02 * a12 - a01 * a22
        i02 = a01 * a12 - a02 * a11
        i11 = a00 * a22 - a02 * a02
        i12 = a02 * a01 - a00 * a12
        i22 = a00 * a11 - a01 * a01
        dA = (i00 * b0 + i01 * b1 + i02 * b2) / det
        dx0 = (i01 * b0 + i11 * b1 + i12 * b2) / det
        dg = (i02 * b0 + i12 * b1 + i22 * b2) / det
        A = torch.clamp(A + dA, min=1e-12)
        x0 = torch.clamp(x0 + dx0, 0.0, n - 1.0)
        gamma = torch.clamp(gamma + dg, 0.3, float(n))
    return x0, gamma, A


def pseudo_voigt_reference(patches: torch.Tensor, n_iter: int = 5
                           ) -> torch.Tensor:
    """patches (Np, ph, pw) -> (Np, 6) float32: (y0, x0, gy, gx, Ay, Ax).

    Separable fit: pseudo-Voigt Gauss-Newton on the row marginal (the sum
    over columns, giving the y profile) and the column marginal.
    """
    my = patches.sum(dim=2)    # (Np, ph)
    mx = patches.sum(dim=1)    # (Np, pw)
    y0, gy, Ay = pv_fit_1d(my, n_iter)
    x0, gx, Ax = pv_fit_1d(mx, n_iter)
    return torch.stack([y0, x0, gy, gx, Ay, Ax], dim=-1)
