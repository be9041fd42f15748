"""Optimizers of the port (functional, over dicts of tensors) and
learning-rate schedules."""
from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    adafactor,
    adam,
    adamw,
    global_norm,
    sgd,
)
from repro_torch.optim import schedules  # noqa: F401,E402
