"""LR schedules (port of ``repro.optim.schedules``).  WSD
(warmup-stable-decay) is MiniCPM's schedule (arXiv:2404.06395); cosine
is the default elsewhere.  ``lr(step)`` takes a Python int or a 0-d
tensor and returns a 0-d fp32 tensor on the step's device."""
from __future__ import annotations

import math

import torch


def _as_step(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.float()
    return torch.tensor(float(step), dtype=torch.float32)


def wsd_schedule(peak_lr: float, total_steps: int,
                 warmup_frac: float = 0.01, decay_frac: float = 0.1,
                 floor: float = 0.1):
    warm = max(1, int(total_steps * warmup_frac))
    decay_start = int(total_steps * (1 - decay_frac))

    def lr(step):
        step = _as_step(step)
        warm_lr = peak_lr * step / warm
        decay_t = (step - decay_start) / max(1, total_steps - decay_start)
        decay_lr = peak_lr * torch.exp(math.log(floor) * torch.clamp(decay_t, 0.0, 1.0))
        stable = torch.full_like(step, peak_lr)
        return torch.where(step < warm, warm_lr,
                           torch.where(step < decay_start, stable, decay_lr))
    return lr


def cosine_schedule(peak_lr: float, total_steps: int,
                    warmup_frac: float = 0.01, floor_frac: float = 0.1):
    warm = max(1, int(total_steps * warmup_frac))

    def lr(step):
        step = _as_step(step)
        warm_lr = peak_lr * step / warm
        t = torch.clamp((step - warm) / max(1, total_steps - warm), 0.0, 1.0)
        cos = floor_frac + (1 - floor_frac) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warm, warm_lr, peak_lr * cos)
    return lr
