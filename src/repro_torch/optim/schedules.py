"""Learning-rate schedules.

Port of ``repro/optim/schedules.py``: each schedule maps a step (an int
or a 0-dim tensor) to an f32 0-dim tensor on the CPU, computed as the
reference computes it: the step's fraction of the horizon and every
product and sum in f32. The cosine of the f32 angle is taken in f64 and
rounded to f32, the correctly rounded value (torch's f32 ``cos`` on the
CPU can be one ulp off it, where the reference's is not).
"""
from __future__ import annotations

import math

import torch


def _f32(x):
    return torch.as_tensor(x).to(torch.float32)


def constant_lr(lr):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def cosine_lr(lr, total_steps, final_frac=0.1):
    def sched(step):
        frac = torch.clamp(_f32(step / max(1, total_steps)), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos((math.pi * frac).double()).float())
        return lr * (final_frac + (1 - final_frac) * cos)
    return sched


def warmup_cosine_lr(lr, warmup_steps, total_steps, final_frac=0.1):
    cos = cosine_lr(lr, max(1, total_steps - warmup_steps), final_frac)

    def sched(step):
        warm = _f32(lr * step / max(1, warmup_steps))
        return torch.where(_f32(step) < warmup_steps, warm,
                           cos(step - warmup_steps))
    return sched
