"""Plain AdamW with per-replica global-norm clipping and a warmup +
cosine learning-rate schedule, on dicts of leaves that carry a leading
replica axis R (R=1 for one model). Every replica is its own model: its
gradient norm, clip and step are its own."""
from __future__ import annotations

import math
from typing import Dict, Mapping

import torch

Tree = Dict[str, torch.Tensor]


def learning_rate(step: int, tc: Mapping) -> float:
    """The rate of 1-based ``step``: linear warmup, then cosine (or linear,
    or constant) decay to 0 at ``total_steps``."""
    peak = tc["learning_rate"]
    warm = max(tc["warmup_steps"], 1)
    total = max(tc["total_steps"], warm + 1)
    if step < warm:
        return peak * step / warm
    frac = min(max((step - warm) / (total - warm), 0.0), 1.0)
    kind = tc.get("schedule", "cosine")
    if kind == "cosine":
        return peak * 0.5 * (1.0 + math.cos(math.pi * frac))
    if kind == "linear":
        return peak * (1.0 - frac)
    return peak


def replica_norms(tree: Tree) -> Dict[str, torch.Tensor]:
    """Each leaf's norm per replica, (R,) float32."""
    return {k: torch.linalg.vector_norm(v.float().reshape(v.shape[0], -1),
                                        dim=1) for k, v in tree.items()}


class AdamW:
    """The optimizer's moments and step count for ``params``."""

    def __init__(self, params: Tree, tc: Mapping):
        self.tc = tc
        self.t = 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    def clipped(self, grads: Tree) -> Tree:
        """The gradients each replica's global norm clipped to
        ``grad_clip`` (when it is set)."""
        clip = self.tc.get("grad_clip", 1.0)
        if not clip:
            return grads
        sq = sum(torch.square(n) for n in replica_norms(grads).values())
        scale = torch.clamp(clip / torch.clamp(torch.sqrt(sq), min=1e-9),
                            max=1.0)
        return {k: g * scale.reshape((-1,) + (1,) * (g.dim() - 1))
                for k, g in grads.items()}

    @torch.no_grad()
    def step(self, params: Tree, grads: Tree) -> None:
        """One update of ``params`` in place, from already clipped
        ``grads``."""
        tc = self.tc
        self.t += 1
        b1, b2 = tc.get("b1", 0.9), tc.get("b2", 0.95)
        eps, wd = tc.get("eps", 1e-8), tc.get("weight_decay", 0.0)
        lr = learning_rate(self.t, tc)
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            self.m[k] = b1 * self.m[k] + (1 - b1) * g
            self.v[k] = b2 * self.v[k] + (1 - b2) * g * g
            upd = (self.m[k] / c1) / (torch.sqrt(self.v[k] / c2) + eps)
            p -= lr * (upd + wd * p)
