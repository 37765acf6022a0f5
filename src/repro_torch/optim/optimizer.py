"""AdamW / SGD with momentum on the port's flat parameter dicts, with
global-norm clipping: a copy of the reference's ``optim/optimizer.py``.

Every leaf carries a leading replica (watershed) axis R, as the port's
params do; the reference ``vmap``s the whole update over that axis in
stacked mode, so here the global norm, the clip, the schedule and the
bias corrections are all per replica: the norm is summed over every axis
but R, and the step counter is (R,). The learning rate and the bias
corrections are computed in float32 from the step, as the reference
computes them (``step.astype(float32)``). The update is elementwise, so
it does not care that the LSTM leaves are in the port's gate-split
layout. It returns new tensors (nothing is updated in place).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.optim.schedules import make_schedule

Tree = Dict[str, torch.Tensor]


class OptState(NamedTuple):
    step: torch.Tensor   # int32 (R,): updates taken, per replica
    mu: Tree             # first moment (or momentum for sgd)
    nu: Tree             # second moment (empty for sgd)


def _per_replica(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(R,) -> (R, 1, ..., 1) broadcasting against ``like``."""
    return v.reshape(v.shape + (1,) * (like.dim() - 1))


def clip_by_global_norm(grads: Tree, max_norm: float
                        ) -> Tuple[Tree, torch.Tensor]:
    """Scale each replica's gradients so their global norm is at most
    ``max_norm``. Returns (clipped grads, the norms before clipping (R,))."""
    sq = None
    for g in grads.values():
        s = torch.sum(torch.square(g.float()), dim=tuple(range(1, g.dim())))
        sq = s if sq is None else sq + s
    gnorm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return {k: (g.float() * _per_replica(scale, g)).to(g.dtype)
            for k, g in grads.items()}, gnorm


def _clip(grads: Tree, tc: TrainConfig) -> Tuple[Tree, torch.Tensor]:
    if tc.grad_clip:
        return clip_by_global_norm(grads, tc.grad_clip)
    return grads, clip_by_global_norm(grads, 1e30)[1]


def _zeros(params: Tree) -> Tree:
    return {k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()}


def _steps(params: Tree) -> torch.Tensor:
    p = next(iter(params.values()))
    return torch.zeros(p.shape[0], dtype=torch.int32, device=p.device)


def adamw_init(params: Tree) -> OptState:
    return OptState(step=_steps(params), mu=_zeros(params), nu=_zeros(params))


@torch.no_grad()
def adamw_update(params: Tree, grads: Tree, state: OptState,
                 tc: TrainConfig) -> Tuple[Tree, OptState, Dict]:
    grads, gnorm = _clip(grads, tc)
    step = state.step + 1
    lr = make_schedule(tc)(step)
    b1, b2, eps = tc.b1, tc.b2, tc.eps
    stepf = step.to(torch.float32)
    c1 = 1 - torch.pow(b1, stepf)
    c2 = 1 - torch.pow(b2, stepf)
    new_p, new_mu, new_nu = {}, {}, {}
    for k, p in params.items():
        g = grads[k].float()
        m = b1 * state.mu[k] + (1 - b1) * g
        v = b2 * state.nu[k] + (1 - b2) * torch.square(g)
        mhat = m / _per_replica(c1, m)
        vhat = v / _per_replica(c2, v)
        delta = mhat / (torch.sqrt(vhat) + eps)
        p32 = p.float()
        new_p[k] = (p32 - _per_replica(lr, p) * (delta + tc.weight_decay * p32)
                    ).to(p.dtype)
        new_mu[k], new_nu[k] = m, v
    return new_p, OptState(step=step, mu=new_mu, nu=new_nu), \
        {"lr": lr, "grad_norm": gnorm}


def sgd_init(params: Tree) -> OptState:
    return OptState(step=_steps(params), mu=_zeros(params), nu={})


@torch.no_grad()
def sgd_update(params: Tree, grads: Tree, state: OptState, tc: TrainConfig,
               momentum: float = 0.9) -> Tuple[Tree, OptState, Dict]:
    grads, gnorm = _clip(grads, tc)
    step = state.step + 1
    lr = make_schedule(tc)(step)
    new_p, new_mu = {}, {}
    for k, p in params.items():
        m = momentum * state.mu[k] + grads[k].float()
        new_p[k] = (p.float() - _per_replica(lr, p) * m).to(p.dtype)
        new_mu[k] = m
    return new_p, OptState(step=step, mu=new_mu, nu={}), \
        {"lr": lr, "grad_norm": gnorm}


def make_optimizer(tc: TrainConfig):
    if tc.optimizer == "adamw":
        return adamw_init, lambda p, g, s: adamw_update(p, g, s, tc)
    if tc.optimizer == "sgd":
        return sgd_init, lambda p, g, s: sgd_update(p, g, s, tc)
    raise ValueError(tc.optimizer)
