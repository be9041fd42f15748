"""Seeded weights for a configuration file, made on the device.

The tree has the layout the program's ``build_model(cfg).init`` returns
(``bench/tests/test_weights.py`` holds the two to the same keys, shapes
and dtypes): every layer leaf stacked on a leading layer axis under
``blocks``, an MoE model's leading dense layers as the list
``head_blocks``, the norms in float32 and every other leaf in the served
dtype.  Each stacked leaf is drawn in one call from a ``torch.Generator``
on the device, so a full-size model takes a few dozen calls.  The same
tensors go to the program and, layer by layer, to the reference.

Scales follow the usual fan-in rule (std = 1 / sqrt(fan in); the output
projection 1 / (sqrt(2 L) H); embeddings 0.02).  Biases and norm
parameters are drawn too, not left at zero and one, so that a program
that drops one of them is caught by the comparison.
"""
from __future__ import annotations

from typing import Dict

import torch

from bench.harness import model_config as mc

BIAS_STD = 0.02
NORM_STD = 0.05


def _gen(device: torch.device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    return g


class _Maker:
    def __init__(self, device, dtype, seed: int):
        self.device = torch.device(device)
        self.dtype = dtype
        self.g = _gen(self.device, seed)

    def normal(self, shape, std: float, *, mean: float = 0.0,
               dtype=None) -> torch.Tensor:
        t = torch.empty(tuple(shape), dtype=dtype or self.dtype,
                        device=self.device)
        return t.normal_(mean, std, generator=self.g)

    def norm(self, n: int, d: int, bias: bool) -> Dict[str, torch.Tensor]:
        lead = (n,) if n else ()
        p = {"scale": self.normal(lead + (d,), NORM_STD, mean=1.0,
                                  dtype=torch.float32)}
        if bias:
            p["bias"] = self.normal(lead + (d,), BIAS_STD,
                                    dtype=torch.float32)
        return p


def _attention(m: _Maker, cfg: Dict, n: int) -> Dict:
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    H, Hkv, D = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 mc.head_dim(cfg))
    lead = (n,) if n else ()
    p = {"wq": m.normal(lead + (d, H, D), d ** -0.5),
         "wk": m.normal(lead + (d, Hkv, D), d ** -0.5),
         "wv": m.normal(lead + (d, Hkv, D), d ** -0.5),
         "wo": m.normal(lead + (H, D, d), 1.0 / ((2 * L) ** 0.5 * H))}
    if cfg.get("use_bias"):
        p.update(bq=m.normal(lead + (H, D), BIAS_STD),
                 bk=m.normal(lead + (Hkv, D), BIAS_STD),
                 bv=m.normal(lead + (Hkv, D), BIAS_STD),
                 bo=m.normal(lead + (d,), BIAS_STD))
    return p


def _mlp(m: _Maker, cfg: Dict, n: int, ff: int) -> Dict:
    d = cfg["hidden_size"]
    lead = (n,) if n else ()
    p = {"w_up": m.normal(lead + (d, ff), d ** -0.5),
         "w_down": m.normal(lead + (ff, d), ff ** -0.5)}
    if cfg["hidden_act"] == "silu":
        p["w_gate"] = m.normal(lead + (d, ff), d ** -0.5)
    if cfg.get("use_bias"):
        p.update(b_up=m.normal(lead + (ff,), BIAS_STD),
                 b_down=m.normal(lead + (d,), BIAS_STD))
    return p


def _moe(m: _Maker, cfg: Dict, n: int) -> Dict:
    d, E, h = (cfg["hidden_size"], cfg["n_routed_experts"],
               cfg["moe_intermediate_size"])
    p = {"router": m.normal((n, d, E), d ** -0.5),
         "experts_w_gate": m.normal((n, E, d, h), d ** -0.5),
         "experts_w_up": m.normal((n, E, d, h), d ** -0.5),
         "experts_w_down": m.normal((n, E, h, d), h ** -0.5)}
    if cfg.get("n_shared_experts"):
        p["shared"] = _mlp(m, cfg, n, h * cfg["n_shared_experts"])
    return p


def _block(m: _Maker, cfg: Dict, n: int, *, moe: bool) -> Dict:
    d, bias = cfg["hidden_size"], cfg["norm_type"] == "layer_norm" \
        and bool(cfg.get("use_bias"))
    b = {"attn_norm": m.norm(n, d, bias), "attn": _attention(m, cfg, n),
         "mlp_norm": m.norm(n, d, bias)}
    if moe:
        b["moe"] = _moe(m, cfg, n)
    else:
        b["mlp"] = _mlp(m, cfg, n, cfg["intermediate_size"])
    return b


def make(cfg: Dict, seed: int, *, device="cuda",
         dtype: torch.dtype = torch.bfloat16) -> Dict:
    """The seeded weight tree of configuration file ``cfg``."""
    m = _Maker(device, dtype, seed)
    d, V, L = cfg["hidden_size"], cfg["vocab_size"], cfg["num_hidden_layers"]
    n_head = cfg.get("first_k_dense_replace", 0) if mc.is_moe(cfg) else 0
    p = {"embed": {"embedding": m.normal((V, d), 0.02)}}
    if n_head:
        p["head_blocks"] = [_block(m, cfg, 0, moe=False)
                            for _ in range(n_head)]
    p["blocks"] = _block(m, cfg, L - n_head, moe=mc.is_moe(cfg))
    p["final_norm"] = m.norm(0, d, cfg["norm_type"] == "layer_norm"
                             and bool(cfg.get("use_bias")))
    if not cfg.get("tie_word_embeddings"):
        p["head"] = {"w": m.normal((d, V), d ** -0.5)}
    return p


def layer(tree: Dict, l: int) -> Dict:
    """Layer ``l``'s leaves (the leading dense layers first)."""
    head = tree.get("head_blocks", [])
    if l < len(head):
        return head[l]

    def pick(node):
        return {k: pick(v) if isinstance(v, dict) else v[l - len(head)]
                for k, v in node.items()}
    return pick(tree["blocks"])
