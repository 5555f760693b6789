"""LR schedules: functions of the step count, evaluated in f32 as the JAX
package's ``repro.optim.schedule`` does."""
from __future__ import annotations

import math

import torch


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.1):
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clip((step - warmup_steps)
                          / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return lr


def constant(lr_value: float):
    def lr(step: torch.Tensor) -> torch.Tensor:
        return torch.full((), lr_value, dtype=torch.float32,
                          device=torch.as_tensor(step).device)
    return lr
