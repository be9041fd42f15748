"""BraggNN [arXiv:2008.08198] -- Bragg-peak localization from 11x11 patches.

The counterpart of ``repro/models/braggnn.py``:
  * conv 3x3 (valid) -> 64 channels on the 11x11 patch,
  * a non-local self-attention block over the 9x9 feature map,
  * conv stack 64 -> 32 -> 8 (3x3 valid),
  * FC stack (fcsz = 16, 8, 4, 2) -> (y, x) sub-pixel peak center.
Convs and FCs use leaky-relu (slope 0.01); the output goes through a
sigmoid.

The public layout is the reference's: ``forward`` takes NHWC patches
(B, 11, 11, 1), and the two places where the reference flattens spatial
positions (the non-local block's (B, H*W, C) view and the flatten before
``fc0``) use its (h, w, c) order, so ``fc0_w``'s 200 rows mean the same
in both packages.  Inside, activations are NCHW and conv weights OIHW
(``models/convert.py`` permutes the reference's HWIO weights).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.paper_models import BraggNNConfig
from repro_torch.device import resolve_device
from repro_torch.models.common import dense_init_, fan_in_std

# feature map after three valid 3x3 convs on 11x11: 9 -> 7 -> 5
_FLAT = 5 * 5 * 8


def init_params(cfg: BraggNNConfig = BraggNNConfig(), *, seed: int = 0,
                device="cuda") -> Dict[str, torch.Tensor]:
    """Random float32 parameters with the reference's shapes (conv weights
    as OIHW) and init scales (truncated normal, std 1/sqrt(fan_in), cut
    at +-2 std; zero biases), from a generator seeded with ``seed``."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    c = cfg.base_channels

    def conv(cout, cin, k):
        w = torch.empty((cout, cin, k, k), device=dev)
        return dense_init_(w, g, std=fan_in_std((k * k * cin,)))

    def zeros(n):
        return torch.zeros((n,), device=dev)

    p: Dict[str, torch.Tensor] = {
        "conv1_w": conv(c, 1, 3), "conv1_b": zeros(c),
        # non-local attention block (1x1 convs: theta, phi, g, out)
        "nl_theta": conv(c // 2, c, 1), "nl_phi": conv(c // 2, c, 1),
        "nl_g": conv(c // 2, c, 1), "nl_out": conv(c, c // 2, 1),
        "conv2_w": conv(c // 2, c, 3), "conv2_b": zeros(c // 2),
        "conv3_w": conv(8, c // 2, 3), "conv3_b": zeros(8),
    }
    sizes = (_FLAT,) + tuple(cfg.fcsz)
    for i in range(len(cfg.fcsz)):
        w = torch.empty((sizes[i], sizes[i + 1]), device=dev)
        p[f"fc{i}_w"] = dense_init_(w, g, std=fan_in_std(w.shape))
        p[f"fc{i}_b"] = zeros(sizes[i + 1])
    return p


def _lrelu(v: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(v, 0.01)


def forward(params: Dict[str, torch.Tensor], x: torch.Tensor,
            cfg: BraggNNConfig) -> torch.Tensor:
    """x: (B, 11, 11, 1) normalized patches -> (B, 2) peak centers in
    [0, 1]."""
    h = _lrelu(F.conv2d(x.permute(0, 3, 1, 2), params["conv1_w"],
                        params["conv1_b"]))                  # (B,64,9,9)

    # non-local self-attention over spatial positions, in (h, w) order
    B, _, H, W = h.shape

    def positions(w):
        return F.conv2d(h, w).flatten(2).transpose(1, 2)    # (B, H*W, C')

    theta = positions(params["nl_theta"])
    phi = positions(params["nl_phi"])
    g = positions(params["nl_g"])
    attn = torch.softmax(theta @ phi.transpose(1, 2)
                         / (theta.shape[-1] ** 0.5), dim=-1)
    nl = (attn @ g).transpose(1, 2).reshape(B, -1, H, W)
    h = h + F.conv2d(nl, params["nl_out"])

    h = _lrelu(F.conv2d(h, params["conv2_w"], params["conv2_b"]))  # (B,32,7,7)
    h = _lrelu(F.conv2d(h, params["conv3_w"], params["conv3_b"]))  # (B,8,5,5)
    h = h.permute(0, 2, 3, 1).reshape(B, -1)    # the reference's NHWC order
    n_fc = len(cfg.fcsz)
    for i in range(n_fc):
        h = h @ params[f"fc{i}_w"] + params[f"fc{i}_b"]
        if i < n_fc - 1:
            h = _lrelu(h)
    return torch.sigmoid(h)      # peak center normalized to the patch


def loss_fn(params: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
            cfg: BraggNNConfig) -> Tuple[torch.Tensor, Dict]:
    """Mean squared error of the predicted centers: (mse, {"mse": mse})."""
    pred = forward(params, batch["patches"], cfg)
    mse = torch.mean((pred - batch["centers"]) ** 2)
    return mse, {"mse": mse}
