"""Optimizers of the port (functional, over dicts of tensors)."""
from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    adafactor,
    adam,
    adamw,
    global_norm,
    sgd,
)
