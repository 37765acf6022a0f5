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
layout.

The gradients are always clipped in their own tensors. ``in_place`` is
the port's form of the reference's donated step: the params and the
moments are updated in their own tensors too, and the caller must not
reuse the old state. Without it the update runs the same operations on
copies of them, so both give the same bits and the old state stays
valid.
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


def global_norm(grads: Tree) -> torch.Tensor:
    """Each replica's global gradient norm (R,), summed over every axis
    but R."""
    sq = None
    for g in grads.values():
        s = torch.sum(torch.square(g.float()), dim=tuple(range(1, g.dim())))
        sq = s if sq is None else sq + s
    return torch.sqrt(sq)


def _clip_scale(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: Tree, max_norm: float
                        ) -> Tuple[Tree, torch.Tensor]:
    """Scale each replica's gradients so their global norm is at most
    ``max_norm``. Returns (clipped grads, the norms before clipping (R,))."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, max_norm)
    return {k: (g.float() * _per_replica(scale, g)).to(g.dtype)
            for k, g in grads.items()}, gnorm


def _clip(grads: Tree, tc: TrainConfig) -> Tuple[Tree, torch.Tensor]:
    """``clip_by_global_norm`` in the gradients' own tensors (the update's
    gradients are its own, fresh from the backward) and the norms before
    clipping."""
    gnorm = global_norm(grads)
    if tc.grad_clip:
        scale = _clip_scale(gnorm, tc.grad_clip)
        for g in grads.values():
            g.mul_(_per_replica(scale, g))
    return grads, gnorm


def _zeros(params: Tree) -> Tree:
    return {k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()}


def _steps(params: Tree) -> torch.Tensor:
    p = next(iter(params.values()))
    return torch.zeros(p.shape[0], dtype=torch.int32, device=p.device)


def adamw_init(params: Tree) -> OptState:
    return OptState(step=_steps(params), mu=_zeros(params), nu=_zeros(params))


def _own(tree: Tree, in_place: bool) -> Tree:
    """``tree`` itself to update in place, else a copy of each leaf."""
    return tree if in_place else {k: v.clone() for k, v in tree.items()}


@torch.no_grad()
def adamw_update(params: Tree, grads: Tree, state: OptState,
                 tc: TrainConfig, in_place: bool = False
                 ) -> Tuple[Tree, OptState, Dict]:
    """One AdamW step on float32 params and moments: each leaf's moments,
    then its param, with at most three leaf-sized temporaries alive."""
    grads, gnorm = _clip(grads, tc)
    step = state.step + 1
    lr = make_schedule(tc)(step)
    b1, b2, eps = tc.b1, tc.b2, tc.eps
    stepf = step.to(torch.float32)
    c1 = 1 - torch.pow(b1, stepf)
    c2 = 1 - torch.pow(b2, stepf)
    new_p, new_mu, new_nu = (_own(t, in_place)
                             for t in (params, state.mu, state.nu))
    for k, p in new_p.items():
        g = grads[k].float()
        m = new_mu[k].mul_(b1).add_(g * (1 - b1))
        v = new_nu[k].mul_(b2).add_(torch.square(g).mul_(1 - b2))
        del g
        delta = m / _per_replica(c1, m)
        vhat = v / _per_replica(c2, v)
        delta.div_(vhat.sqrt_().add_(eps))
        del vhat
        delta.add_(tc.weight_decay * p).mul_(_per_replica(lr, p))
        p.sub_(delta)
    return new_p, OptState(step=step, mu=new_mu, nu=new_nu), \
        {"lr": lr, "grad_norm": gnorm}


def sgd_init(params: Tree) -> OptState:
    return OptState(step=_steps(params), mu=_zeros(params), nu={})


@torch.no_grad()
def sgd_update(params: Tree, grads: Tree, state: OptState, tc: TrainConfig,
               momentum: float = 0.9, in_place: bool = False
               ) -> Tuple[Tree, OptState, Dict]:
    grads, gnorm = _clip(grads, tc)
    step = state.step + 1
    lr = make_schedule(tc)(step)
    new_p, new_mu = _own(params, in_place), _own(state.mu, in_place)
    for k, p in new_p.items():
        m = new_mu[k].mul_(momentum).add_(grads[k].float())
        p.sub_(_per_replica(lr, p) * m)
    return new_p, OptState(step=step, mu=new_mu, nu={}), \
        {"lr": lr, "grad_norm": gnorm}


def make_optimizer(tc: TrainConfig, in_place: bool = False):
    """(init, update(params, grads, state)); the update clips the
    gradients in their own tensors, and ``in_place`` updates the params
    and the moments in theirs."""
    if tc.optimizer == "adamw":
        return adamw_init, lambda p, g, s: adamw_update(p, g, s, tc, in_place)
    if tc.optimizer == "sgd":
        return sgd_init, lambda p, g, s: sgd_update(p, g, s, tc,
                                                    in_place=in_place)
    raise ValueError(tc.optimizer)
