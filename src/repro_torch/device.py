"""Device selection shared by the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda"
                   ) -> torch.device:
    """``torch.device(device)``, refusing a CUDA device on a machine that
    has none: entry points default to the card and run on the CPU only
    when the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but CUDA is not available; pass "
                "device='cpu' to run the plain PyTorch path on the CPU")
        if dev.index is None:      # "cuda" -> the current card, explicitly
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def seeded_generator(dev: torch.device, seed: int
                     ) -> Optional[torch.Generator]:
    """A generator on ``dev`` seeded with ``seed``; None on the ``meta``
    device, where an init records only shapes and dtypes (the abstract
    parameter trees the sharding rules read)."""
    if dev.type == "meta":
        return None
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g
