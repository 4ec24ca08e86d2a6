"""LR schedules (counterparts of ``repro.optim.schedules``).  WSD
(warmup-stable-decay) is minicpm-2b's signature feature
(arXiv:2404.06395): linear warmup, long flat stable phase, sharp (here
cosine) decay over the final ~10%.

Each schedule takes the step as a 0-d tensor (the optimizer's ``count``)
or a number and returns the lr as a 0-d f32 tensor on the step's device,
so reading the lr inside a train step costs no host sync.
"""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def linear_warmup(step, warmup_steps, peak):
    return peak * torch.clamp(step / max(warmup_steps, 1), max=1.0)


def wsd_schedule(step, *, peak: float, warmup_steps: int, total_steps: int,
                 decay_frac: float = 0.1, floor_frac: float = 0.01):
    """Warmup-Stable-Decay."""
    step = _f32(step)
    decay_steps = decay_frac * total_steps
    decay_start = total_steps - decay_steps
    warm = linear_warmup(step, warmup_steps, peak)
    t = torch.clamp((step - decay_start) / max(decay_steps, 1), 0.0, 1.0)
    decay = peak * (floor_frac + (1 - floor_frac) * 0.5
                    * (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup_steps, warm,
                       torch.where(step < decay_start, peak, decay))


def cosine_schedule(step, *, peak: float, warmup_steps: int, total_steps: int,
                    floor_frac: float = 0.1):
    step = _f32(step)
    warm = linear_warmup(step, warmup_steps, peak)
    t = torch.clamp((step - warmup_steps)
                    / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = peak * (floor_frac + (1 - floor_frac) * 0.5
                  * (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup_steps, warm, cos)


def get_schedule(name: str, **kw):
    return {"wsd": wsd_schedule, "cosine": cosine_schedule}[name], kw
