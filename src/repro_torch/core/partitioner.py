"""Partitioning module (paper Fig. 1b): dynamically partitions
spatiotemporal pixels by contribution.

Pixels are ranked by Pix-Con weight and split into ``num_partitions``
contiguous rank groups; group g feeds spatial-block head g. The sort
indices are data-dependent (dynamic partitioning, per example).
"""
from __future__ import annotations

from typing import Tuple

import torch


def partition_pixels(x: torch.Tensor, w: torch.Tensor, num_partitions: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., T, P) weighted inputs, w (..., P) contributions.

    Returns (parts (..., G, T, P//G) -- pixels regrouped by contribution rank,
             order (..., P) -- the permutation used).
    Highest-contribution pixels land in partition 0; equal weights keep
    pixel order (a stable sort, as ``jnp.argsort`` is).
    """
    T, P = x.shape[-2:]
    G = num_partitions
    if P % G:
        raise ValueError(f"pixels {P} not divisible by partitions {G}")
    order = torch.argsort(-w.detach(), dim=-1, stable=True)     # desc
    xg = torch.gather(x, -1, order.unsqueeze(-2).expand(x.shape))
    parts = xg.reshape(*x.shape[:-1], G, P // G).transpose(-3, -2)
    return parts, order


def static_partition(x: torch.Tensor, num_partitions: int) -> torch.Tensor:
    """Baseline (no domain guidance): contiguous pixel blocks in raster order."""
    T, P = x.shape[-2:]
    G = num_partitions
    if P % G:
        raise ValueError(f"pixels {P} not divisible by partitions {G}")
    return x.reshape(*x.shape[:-1], G, P // G).transpose(-3, -2)
