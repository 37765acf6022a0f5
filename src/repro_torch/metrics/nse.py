"""Nash–Sutcliffe efficiency — the paper's model-evaluation metric [13,14].

NSE = 1 - sum((obs - sim)^2) / sum((obs - mean(obs))^2)

NSE = 1 is a perfect model; NSE = 0 matches the observed mean; NSE < 0 is
worse than predicting the mean.
"""
from __future__ import annotations

import torch


def nse(sim: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
    """NSE over the last axis; leading axes (e.g. watersheds) are batched."""
    sim = sim.to(torch.float32)
    obs = obs.to(torch.float32)
    num = torch.sum(torch.square(obs - sim), dim=-1)
    den = torch.sum(torch.square(obs - obs.mean(dim=-1, keepdim=True)), dim=-1)
    return 1.0 - num / torch.clamp_min(den, 1e-12)
