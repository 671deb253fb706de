"""LR schedules (pure functions of the step counter), the mirror of
:mod:`repro.optim.schedules`: float32 arithmetic on a 0-d tensor (the
step's device), so the rate equals the reference's bit for bit."""
from __future__ import annotations

import math
from typing import Callable

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def linear_warmup(peak: float, warmup_steps: int) -> Callable:
    def fn(step):
        s = _f32(step)
        return peak * torch.clamp(s / max(warmup_steps, 1), max=1.0)
    return fn


def cosine_schedule(peak: float, warmup_steps: int, total_steps: int,
                    final_frac: float = 0.1) -> Callable:
    def fn(step):
        s = _f32(step)
        warm = peak * torch.clamp(s / max(warmup_steps, 1), max=1.0)
        t = torch.clamp((s - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        # the float32 cosine correctly rounded (through float64), as
        # XLA's is where torch's float32 one can be an ulp off
        c = torch.cos((math.pi * t).to(torch.float64)).to(torch.float32)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + c)
        return torch.where(s < warmup_steps, warm, peak * cos)
    return fn
