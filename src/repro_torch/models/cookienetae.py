"""CookieNetAE -- the 16-channel eToF energy-pdf estimator (paper §5.2).

The counterpart of ``repro/models/cookienetae.py``: 8 convolutions, ReLU
after all but the last, MSE loss, trained with Adam at lr 1e-3.  Input:
one image (16 channels x 128 energy bins) of per-channel empirical
histograms; output: the energy-angle probability density per channel
(the same shape, softmax-normalized along the energy bins).

The paper states 343,937 trainable parameters; its layer widths are not
public.  The reference's stack, kept here, is 1->32->64->128->128->64->32
->16 (3x3, "SAME") and a 1x1 head 16->1: 337,153 parameters.

The public layout is the reference's NHWC: ``forward`` takes and returns
(B, 16, 128, 1).  Inside, activations are NCHW (B, 1, 16, 128) and conv
weights OIHW (``models/convert.py`` permutes the reference's HWIO
weights), so the reference's softmax over axis 2 of NHWC, the energy
bins, is ``dim=-1`` here.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.paper_models import CookieNetAEConfig
from repro_torch.device import resolve_device
from repro_torch.models.common import dense_init_, fan_in_std

_STACK = [
    # (kernel, cin, cout)
    (3, 1, 32),
    (3, 32, 64),
    (3, 64, 128),
    (3, 128, 128),
    (3, 128, 64),
    (3, 64, 32),
    (3, 32, 16),
    (1, 16, 1),
]
N_PARAMS = 337_153


def init_params(cfg: CookieNetAEConfig = CookieNetAEConfig(), *,
                seed: int = 0, device="cuda") -> Dict[str, torch.Tensor]:
    """Random float32 parameters with the reference's shapes (conv weights
    as OIHW) and init (truncated normal on [-2, 2] std, std
    1/sqrt(kh * kw * cin); zero biases), from a generator seeded with
    ``seed``."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    p: Dict[str, torch.Tensor] = {}
    for i, (k, cin, cout) in enumerate(_STACK):
        w = torch.empty((cout, cin, k, k), device=dev)
        p[f"conv{i}_w"] = dense_init_(w, g, std=fan_in_std((k * k * cin,)))
        p[f"conv{i}_b"] = torch.zeros((cout,), device=dev)
    return p


def forward(params: Dict[str, torch.Tensor], x: torch.Tensor,
            cfg: CookieNetAEConfig) -> torch.Tensor:
    """x: (B, 16, 128, 1) histograms -> (B, 16, 128, 1) energy pdf."""
    h = x.permute(0, 3, 1, 2)                          # (B, 1, 16, 128)
    last = len(_STACK) - 1
    for i, (k, _, _) in enumerate(_STACK):
        # "SAME" at stride 1: k // 2 on each side
        h = F.conv2d(h, params[f"conv{i}_w"], params[f"conv{i}_b"],
                     padding=k // 2)
        if i < last:
            h = F.relu(h)
    # probability density along the energy bins (the reference's NHWC
    # axis 2)
    return torch.softmax(h, dim=-1).permute(0, 2, 3, 1)


def loss_fn(params: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
            cfg: CookieNetAEConfig) -> Tuple[torch.Tensor, Dict]:
    """Mean squared error of the predicted pdf: (mse, {"mse": mse})."""
    pred = forward(params, batch["images"], cfg)
    mse = torch.mean((pred - batch["targets"]) ** 2)
    return mse, {"mse": mse}
