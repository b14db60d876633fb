"""LR schedules (warmup + cosine / constant-then-decay, V3-style) — port of
``repro.train.schedule``.

Evaluated in fp32 on CPU scalars, as the reference evaluates them in
fp32: each Python constant meets the fp32 step as an fp32 value. In
float64 the learning rate differs from the reference's in the last ulp,
and trajectories then drift. Returns a 0-dim fp32 tensor.
"""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32).reshape(())


def warmup_cosine(step, *, peak_lr: float, warmup: int, total: int,
                  final_frac: float = 0.1) -> torch.Tensor:
    step = _f32(step)
    warm = peak_lr * torch.clamp_max(step / max(warmup, 1), 1.0)
    t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < warmup, warm, peak_lr * cos)


def constant_with_warmup(step, *, peak_lr: float,
                         warmup: int) -> torch.Tensor:
    step = _f32(step)
    return peak_lr * torch.clamp_max(step / max(warmup, 1), 1.0)
