"""Learning-rate schedules (callables step -> lr), the counterpart of
``repro/optim/schedules.py``: the step is an integer tensor (the
optimizers' ``state["step"]``) or a Python int, the rate a float32
tensor on the step's device."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def fn(step):
        s = _f32(step)
        warm = peak_lr * s / max(warmup_steps, 1)
        prog = torch.clamp((s - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(s < warmup_steps, warm, cos)

    return fn


def inverse_sqrt(peak_lr: float, warmup_steps: int):
    def fn(step):
        s = torch.clamp(_f32(step), min=1.0)
        warm = peak_lr * s / max(warmup_steps, 1)
        decay = peak_lr * (warmup_steps ** 0.5) / torch.sqrt(s)
        return torch.where(s < warmup_steps, warm, decay)

    return fn
