"""Learning-rate schedules (pure functions of the step counter), a copy of
the reference's ``optim/schedules.py``. The step is taken as float32 and
every operation runs in float32, as the reference's ``jnp`` arithmetic
does, never in Python doubles."""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import TrainConfig


def make_schedule(tc: TrainConfig):
    """Returns step -> lr (float32 tensor of the step's shape)."""
    peak = tc.learning_rate
    warm = max(tc.warmup_steps, 1)
    total = max(tc.total_steps, warm + 1)
    if tc.schedule not in ("cosine", "linear", "constant"):
        raise ValueError(tc.schedule)

    def sched(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm_lr = peak * step / warm
        frac = torch.clamp((step - warm) / (total - warm), 0.0, 1.0)
        if tc.schedule == "cosine":
            post = peak * 0.5 * (1.0 + torch.cos(math.pi * frac))
        elif tc.schedule == "linear":
            post = peak * (1.0 - frac)
        else:
            post = torch.full_like(frac, peak)
        return torch.where(step < warm, warm_lr, post)

    return sched
