"""Configs for the paper's own edge DNNs: BraggNN and CookieNetAE.

The port's own copy of the reference package's ``configs/paper_models.py``.
These are not part of the architecture pool; they are the models the paper
(re)trains through its workflow (Table 1).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class BraggNNConfig:
    """BraggNN [arXiv:2008.08198]: 11x11 Bragg-peak patch -> (y, x) center."""

    name: str = "braggnn"
    patch: int = 11
    base_channels: int = 64          # first conv width
    fcsz: tuple = (16, 8, 4, 2)      # fully-connected stack
    imgsz: int = 11

    @property
    def input_shape(self) -> tuple:
        return (self.patch, self.patch, 1)


@dataclass(frozen=True)
class CookieNetAEConfig:
    """CookieNetAE: 16-channel eToF energy-histogram image -> per-channel pdf.

    8 convolution layers, ReLU activations, MSE loss, Adam lr=1e-3 (paper
    §5.2).  The paper states 343,937 trainable parameters but not its
    layer widths; the reference's stack, which the port keeps
    (``models/cookienetae.py``), has 337,153, within 2 % of the paper's.
    """

    name: str = "cookienetae"
    channels: int = 16               # CookieBox eToF channels (image rows)
    bins: int = 128                  # 1 eV energy bins (image cols)

    @property
    def input_shape(self) -> tuple:
        return (self.channels, self.bins, 1)
