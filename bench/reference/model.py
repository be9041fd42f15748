"""The plain float32 reference of the benchmark's decoder configurations.

Written from the published descriptions (StarCoder2, arXiv:2402.19173;
DeepSeekMoE, arXiv:2401.06066) with the values of a configuration file
of ``bench/configs/``, and plain ``torch`` operations only: no kernel,
no cache, no batching across sequences.  It imports nothing of the
program.  Each sequence runs whole from its first token:

* the token embedding;
* per layer: the pre-attention norm (layer norm with bias, or RMS norm),
  the Q/K/V projections (with biases where the file says so), rotary
  embeddings (half split) at the token positions, causal attention over
  the keys within the sliding window (a key ``j`` is seen by query ``i``
  when ``j <= i`` and ``i - j < window``), the output projection and the
  residual add; the pre-MLP norm and the MLP: a GELU (tanh) MLP with
  biases, or a SwiGLU MLP, or, past the leading dense layers, the MoE
  layer (below), and its residual add;
* the final norm and the output head.

The MoE layer: router logits in float32, softmax over the routed
experts, the top ``num_experts_per_tok``, their gates renormalised over
the chosen (``norm_topk_prob``); each expert takes at most ``C = ceil(S k
/ E * capacity_factor)`` (token, choice) pairs of a group of ``S``
tokens, claimed in (token, choice) order, and a pair past ``C`` adds
nothing; the shared experts see every token.  A sequence is one group.

The weights are the benchmark's own tensors (``bench/harness/weights``),
read one layer at a time and widened to float32, so the reference fits
beside them.  ``quant="fp8"`` is the control: every linear layer but
the router takes its inputs rounded to float8 (e4m3, one scale per
weight column and per activation row), as a float8 matmul would.
Float32 products run with TF32 off.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def _eps(cfg: Dict) -> float:
    return float(cfg.get("norm_epsilon", cfg.get("rms_norm_eps", 1e-6)))


def _head_dim(cfg: Dict) -> int:
    return cfg.get("head_dim") or (cfg["hidden_size"]
                                   // cfg["num_attention_heads"])


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along
    ``dim``'s complement (amax over ``dim`` maps to 448), back in
    float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Linear:
    """``x @ w`` in float32, or with both inputs rounded to float8."""

    def __init__(self, quant: Optional[str]):
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown quant {quant!r}")
        self.quant = quant

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        w = w.to(torch.float32)
        if self.quant == "fp8":
            x = _fp8(x, dim=-1)
            w = _fp8(w, dim=0)
        return x @ w


def norm(cfg: Dict, p: Dict, x: torch.Tensor) -> torch.Tensor:
    eps = _eps(cfg)
    if cfg["norm_type"] == "layer_norm":
        mu = x.mean(dim=-1, keepdim=True)
        var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
        y = (x - mu) * torch.rsqrt(var + eps) * p["scale"].float()
        return y + p["bias"].float() if "bias" in p else y
    var = (x * x).mean(dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * p["scale"].float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, half split: x (S, H, D), pos (S,)."""
    D = x.shape[-1]
    half = D // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                        device=x.device) / half))
    ang = pos.to(torch.float32)[:, None] * inv[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              window: int, block: int = 512) -> torch.Tensor:
    """Causal attention of one sequence, q (S, H, D), k/v (S, Hkv, D),
    in blocks of ``block`` queries against their band of keys."""
    S, H, D = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    out = torch.empty_like(q)
    scale = 1.0 / math.sqrt(D)
    for a in range(0, S, block):
        b = min(S, a + block)
        k0 = max(0, a - window + 1) if window else 0
        qi = q[a:b].reshape(b - a, Hkv, G, D)
        s = torch.einsum("qhgd,khd->hgqk", qi, k[k0:b]) * scale
        qp = torch.arange(a, b, device=q.device)[:, None]
        kp = torch.arange(k0, b, device=q.device)[None, :]
        ok = kp <= qp
        if window:
            ok &= (qp - kp) < window
        s = s.masked_fill(~ok, float("-inf"))
        w = torch.softmax(s, dim=-1)
        o = torch.einsum("hgqk,khd->qhgd", w, v[k0:b])
        out[a:b] = o.reshape(b - a, H, D)
    return out


def mlp(cfg: Dict, p: Dict, x: torch.Tensor, lin: Linear) -> torch.Tensor:
    if "w_gate" in p:
        h = F.silu(lin(x, p["w_gate"])) * lin(x, p["w_up"])
    else:
        h = lin(x, p["w_up"])
        if "b_up" in p:
            h = h + p["b_up"].float()
        h = F.gelu(h, approximate="tanh")
    y = lin(h, p["w_down"])
    return y + p["b_down"].float() if "b_down" in p else y


def moe(cfg: Dict, p: Dict, x: torch.Tensor, lin: Linear,
        group: Optional[int] = None) -> torch.Tensor:
    """The MoE layer over one group of S tokens, x (S, d).  ``group``
    (default S) is the group's length for the capacity, where padding
    rows that claim after every real row complete the group."""
    S = x.shape[0] if group is None else int(group)
    E, k = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    logits = x @ p["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)
    if cfg.get("norm_topk_prob"):
        gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    C = max(1, math.ceil(S * k / E * float(cfg["capacity_factor"])))
    # the i-th claim on expert e, in (token, choice) order, is kept when
    # fewer than C claims precede it
    flat = idx.reshape(-1)
    onehot = F.one_hot(flat, E)
    before = (torch.cumsum(onehot, dim=0) - onehot).gather(
        1, flat[:, None])[:, 0]
    keep = (before < C).reshape(x.shape[0], k)
    y = torch.zeros_like(x)
    for e in range(E):
        tok, choice = torch.nonzero((idx == e) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        h = F.silu(lin(xe, p["experts_w_gate"][e])) * lin(
            xe, p["experts_w_up"][e])
        ye = lin(h, p["experts_w_down"][e])
        y.index_add_(0, tok, ye * gates[tok, choice][:, None])
    if "shared" in p:
        y = y + mlp(cfg, p["shared"], x, lin)
    return y


def logits(cfg: Dict, layer_weights: Callable[[int], Dict], top: Dict,
           seqs: Sequence[torch.Tensor], rows: Sequence[torch.Tensor], *,
           quant: Optional[str] = None, device="cuda") -> List[torch.Tensor]:
    """Float32 logits of each sequence of ``seqs`` (int64 token ids, one
    sequence each) at its positions ``rows[i]``: a list of (len(rows[i]),
    vocab) tensors.  ``layer_weights(l)`` returns layer ``l``'s leaves
    (widened here one layer at a time); ``top`` holds ``embed``,
    ``final_norm`` and ``head`` (or none: tied)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _logits(cfg, layer_weights, top, seqs, rows, quant, device)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def keys_values(cfg: Dict, layer_weights: Callable[[int], Dict], top: Dict,
                seqs: Sequence[torch.Tensor], n_layers: int, *,
                quant: Optional[str] = None,
                device="cuda") -> List[List[tuple]]:
    """The float32 keys and values (after RoPE) that each sequence of
    ``seqs``, run whole from its first token, holds at layers ``0 ..
    n_layers - 1``: per sequence a list of (K, V), each (len, Hkv, D)."""
    cuts = [0]
    for s in seqs:
        cuts.append(cuts[-1] + len(s))
    out: List[List[tuple]] = [[] for _ in seqs]

    def seen(l, k, v):
        for i, (c0, c1) in enumerate(zip(cuts[:-1], cuts[1:])):
            out[i].append((k[c0:c1], v[c0:c1]))

    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        _logits(cfg, layer_weights, top, seqs, None, quant, device,
                on_kv=seen, stop=n_layers)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    return out


@torch.no_grad()
def _logits(cfg, layer_weights, top, seqs, rows, quant, device, on_kv=None,
            stop=None):
    lin = Linear(quant)
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    D = _head_dim(cfg)
    window = int(cfg.get("sliding_window") or 0)
    n_dense = cfg.get("first_k_dense_replace", 0) \
        if cfg.get("n_routed_experts") else cfg["num_hidden_layers"]
    seqs = [s.to(device=device, dtype=torch.long) for s in seqs]
    lens = [len(s) for s in seqs]
    cuts = [0]
    for n in lens:
        cuts.append(cuts[-1] + n)
    pos = torch.cat([torch.arange(n, device=device) for n in lens])
    x = top["embed"]["embedding"][torch.cat(seqs)].to(torch.float32)
    for l in range(cfg["num_hidden_layers"]):
        p = layer_weights(l)
        a = p["attn"]
        h = norm(cfg, p["attn_norm"], x)
        q = lin(h, a["wq"].reshape(a["wq"].shape[0], -1))
        kk = lin(h, a["wk"].reshape(a["wk"].shape[0], -1))
        vv = lin(h, a["wv"].reshape(a["wv"].shape[0], -1))
        if "bq" in a:
            q = q + a["bq"].float().reshape(-1)
            kk = kk + a["bk"].float().reshape(-1)
            vv = vv + a["bv"].float().reshape(-1)
        theta = float(cfg["rope_theta"])
        q = rope(q.reshape(-1, H, D), pos, theta)
        kk = rope(kk.reshape(-1, Hkv, D), pos, theta)
        vv = vv.reshape(-1, Hkv, D)
        if on_kv is not None:
            on_kv(l, kk, vv)
        if stop is not None and l + 1 >= stop:
            return None
        o = torch.cat([attention(q[c0:c1], kk[c0:c1], vv[c0:c1], window)
                       for c0, c1 in zip(cuts[:-1], cuts[1:])])
        y = lin(o.reshape(o.shape[0], -1), a["wo"].reshape(H * D, -1))
        if "bo" in a:
            y = y + a["bo"].float()
        x = x + y
        del q, kk, vv, o, y
        h = norm(cfg, p["mlp_norm"], x)
        if l < n_dense:
            x = x + mlp(cfg, p["mlp"], h, lin)
        else:
            x = x + torch.cat([moe(cfg, p["moe"], h[c0:c1], lin)
                               for c0, c1 in zip(cuts[:-1], cuts[1:])])
        del h
    out = []
    w = (top["embed"]["embedding"].T if cfg.get("tie_word_embeddings")
         else top["head"]["w"])
    for c0, r in zip(cuts[:-1], rows):
        hr = norm(cfg, top["final_norm"], x[c0 + r.to(device)])
        out.append(lin(hr, w))
    return out


def step_logits(cfg: Dict, layer_weights: Callable[[int], Dict], top: Dict,
                tokens: torch.Tensor, positions: torch.Tensor,
                segments: Sequence, context: Callable, n_group: int,
                rows: torch.Tensor, *, quant: Optional[str] = None,
                device="cuda",
                on_kv: Optional[Callable] = None) -> torch.Tensor:
    """One served step recomputed: the float32 logits at ``rows`` of the
    step's real rows ``tokens`` / ``positions`` (stream order).

    ``segments`` are ``(row0, n)``: each request's rows; a segment's
    queries attend to its own earlier rows and to the keys and values of
    its earlier positions, which ``context(l, i)`` returns for layer
    ``l`` and segment ``i`` as float32 (K, V), each (c, Hkv, D), for the
    ``c`` positions just before the segment's first.  Those come from
    the served program's cache: this is the one place where the
    reference takes the program's state, because an MoE layer's routes
    depend on every row of the step (one capacity group of ``n_group``
    rows, the step's padded length), so a step can only be followed from
    the cache it ran on.  ``on_kv(l, k, v)`` sees each layer's keys and
    values of the step's rows (after RoPE)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return _step(cfg, layer_weights, top, tokens, positions,
                         segments, context, n_group, rows, quant, device,
                         on_kv)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _segment_attention(q, k, v, kc, vc, start: int, window: int):
    """Queries q (n, H, D) at positions start.. attend to the context
    (kc, vc) (c, Hkv, D), positions start - c .., then to their own
    segment's k, v."""
    n, H, D = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    c = kc.shape[0]
    keys = torch.cat([kc, k]) if c else k
    vals = torch.cat([vc, v]) if c else v
    qp = torch.arange(start, start + n, device=q.device)[:, None]
    kp = torch.arange(start - c, start + n, device=q.device)[None, :]
    ok = kp <= qp
    if window:
        ok &= (qp - kp) < window
    qi = q.reshape(n, Hkv, G, D)
    s = torch.einsum("qhgd,khd->hgqk", qi, keys) / math.sqrt(D)
    s = s.masked_fill(~ok, float("-inf"))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("hgqk,khd->qhgd", w, vals).reshape(n, H, D)


def _step(cfg, layer_weights, top, tokens, positions, segments, context,
          n_group, rows, quant, device, on_kv):
    lin = Linear(quant)
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    D = _head_dim(cfg)
    window = int(cfg.get("sliding_window") or 0)
    n_dense = cfg.get("first_k_dense_replace", 0) \
        if cfg.get("n_routed_experts") else cfg["num_hidden_layers"]
    tokens = tokens.to(device=device, dtype=torch.long)
    pos = positions.to(device=device, dtype=torch.long)
    x = top["embed"]["embedding"][tokens].to(torch.float32)
    theta = float(cfg["rope_theta"])
    for l in range(cfg["num_hidden_layers"]):
        p = layer_weights(l)
        a = p["attn"]
        h = norm(cfg, p["attn_norm"], x)
        q = lin(h, a["wq"].reshape(a["wq"].shape[0], -1))
        kk = lin(h, a["wk"].reshape(a["wk"].shape[0], -1))
        vv = lin(h, a["wv"].reshape(a["wv"].shape[0], -1))
        if "bq" in a:
            q = q + a["bq"].float().reshape(-1)
            kk = kk + a["bk"].float().reshape(-1)
            vv = vv + a["bv"].float().reshape(-1)
        q = rope(q.reshape(-1, H, D), pos, theta)
        kk = rope(kk.reshape(-1, Hkv, D), pos, theta)
        vv = vv.reshape(-1, Hkv, D)
        if on_kv is not None:
            on_kv(l, kk, vv)
        o = torch.empty_like(q)
        for i, (r0, n) in enumerate(segments):
            kc, vc = context(l, i)
            o[r0:r0 + n] = _segment_attention(
                q[r0:r0 + n], kk[r0:r0 + n], vv[r0:r0 + n], kc, vc,
                int(pos[r0]), window)
        y = lin(o.reshape(o.shape[0], -1), a["wo"].reshape(H * D, -1))
        if "bo" in a:
            y = y + a["bo"].float()
        x = x + y
        h = norm(cfg, p["mlp_norm"], x)
        if l < n_dense:
            x = x + mlp(cfg, p["mlp"], h, lin)
        else:
            x = x + moe(cfg, p["moe"], h, lin, group=n_group)
    w = (top["embed"]["embedding"].T if cfg.get("tie_word_embeddings")
         else top["head"]["w"])
    return lin(norm(cfg, top["final_norm"], x[rows.to(device)]), w)
