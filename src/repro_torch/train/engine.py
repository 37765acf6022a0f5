"""The training engine on one device.

One :class:`Engine` owns what a training loop needs around a
``loss_fn(params, batch) -> (loss (R,), metrics)``:

  * gradient accumulation over ``accum_steps`` microbatches: a Python loop
    over slices of the per-replica batch axis (the reference scans them),
    gradients and metrics summed in float32 and averaged;
  * the stacked/IP-D mode (paper Fig. 2a): every leaf of the params and
    batch carries a leading watershed axis R, the port's written-out form
    of the reference's ``jax.vmap`` of the step; single mode is R=1, with
    the batch's axis added by ``place_batch`` and the metrics returned
    without it;
  * the optimizer update, held-out evaluation and checkpoint save/restore
    of the full state.

There are no meshes and no shardings, like the port's ``Forecaster``, and
nothing is donated: each step returns a new state (new tensors for the
params and moments, rebound, never updated in place), and the old one
stays valid. ``Engine.for_domst`` binds the Dom-ST path; on the card its
forward runs the Pix-Con and LSTM-step kernels and its backward runs
autograd through their plain versions (``kernels/*/ops.py``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import checkpoint as ckpt
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import domst
from repro_torch.device import as_f32, resolve_device
from repro_torch.optim import make_optimizer
from repro_torch.optim.optimizer import Tree
from repro_torch.train.state import TrainState, new_train_state

Batch = Dict[str, torch.Tensor]
LossFn = Callable[[Tree, Batch], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def _microbatches(batch: Batch, accum: int) -> List[Batch]:
    """``batch`` cut into ``accum`` contiguous slices along the per-replica
    batch axis (axis 1)."""
    mb = next(iter(batch.values())).shape[1] // accum
    return [{k: v.narrow(1, i * mb, mb).contiguous()
             for k, v in batch.items()} for i in range(accum)]


def accumulate_grads(loss_fn: LossFn, params: Tree, batch: Batch, accum: int
                     ) -> Tuple[Tree, torch.Tensor, Dict]:
    """(grads, loss (R,), metrics) for one macrostep of ``loss_fn``.

    The gradient is that of ``loss.sum()`` over the replicas, which share
    nothing. ``accum > 1`` splits the per-replica batch axis into
    microbatches; grads, losses and metrics accumulate in float32 and are
    averaged. The caller checks that the axis divides.
    """
    names = list(params)
    leaves = [params[k].detach().requires_grad_() for k in names]
    tree = dict(zip(names, leaves))

    def value_and_grad(b: Batch):
        loss, mets = loss_fn(tree, b)
        grads = torch.autograd.grad(loss.sum(), leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return loss.detach(), {k: v.detach() for k, v in mets.items()}, grads

    if accum == 1:
        loss, mets, grads = value_and_grad(batch)
        return dict(zip(names, grads)), loss, mets
    gsum = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
    lsum, msum = 0.0, None
    for b in _microbatches(batch, accum):
        loss, mets, grads = value_and_grad(b)
        gsum = [a + g.float() for a, g in zip(gsum, grads)]
        lsum = lsum + loss.float()
        msum = {k: (0.0 if msum is None else msum[k]) + v.float()
                for k, v in mets.items()}
    return ({k: g / accum for k, g in zip(names, gsum)}, lsum / accum,
            {k: m / accum for k, m in msum.items()})


class Engine:
    """Training step factory on one device (``device`` defaults to the
    card and raises without one)."""

    def __init__(self, loss_fn: LossFn, tc: TrainConfig, *,
                 stacked: bool = False,
                 accum_steps: Optional[int] = None,
                 device: str | torch.device = "cuda",
                 eval_fn: Optional[Callable[[Tree, Batch], Dict]] = None):
        self.loss_fn = loss_fn
        self.eval_fn = eval_fn
        self.tc = tc
        self.accum = int(accum_steps) if accum_steps else max(tc.grad_accum, 1)
        self.stacked = stacked
        self.device = resolve_device(device)
        self._opt_update = make_optimizer(tc)[1]

    @classmethod
    def for_domst(cls, cfg: ModelConfig, tc: TrainConfig, *,
                  stacked: bool = False, accum_steps: Optional[int] = None,
                  device: str | torch.device = "cuda",
                  ops: domst.KernelOps = domst.KERNELS) -> "Engine":
        """Dom-ST flood engine (sequential or stacked/IP-D). ``ops=PLAIN``
        serves only to hold the kernels' run against the plain one."""
        return cls(lambda p, b: domst.loss_fn(p, cfg, b, ops), tc,
                   stacked=stacked, accum_steps=accum_steps, device=device,
                   eval_fn=lambda p, b: domst.eval_metrics(p, cfg, b, ops))

    # -- state lifecycle ---------------------------------------------------
    def init_state(self, params: Tree) -> TrainState:
        """Fresh TrainState around ``params`` (leading replica axis; R=1 in
        single mode), placed on the device as contiguous float32."""
        params = {k: as_f32(v, self.device) for k, v in params.items()}
        return new_train_state(params, self.tc, stacked=self.stacked)

    def save(self, path: str, state: TrainState) -> None:
        ckpt.save(path, state)

    def restore(self, path: str, example: TrainState) -> TrainState:
        return ckpt.restore(path, example)

    def place_batch(self, batch: Dict[str, Any]) -> Batch:
        """A host batch as contiguous float32 tensors on the device, with
        the leading replica axis (added in single mode): the loader's
        placement hook."""
        out = {k: as_f32(v, self.device) for k, v in batch.items()}
        return out if self.stacked else {k: v[None] for k, v in out.items()}

    # -- the step ----------------------------------------------------------
    def _unstack(self, mets: Dict) -> Dict:
        return mets if self.stacked else {k: v[0] for k, v in mets.items()}

    def step(self, state: TrainState, batch: Batch
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One (macro)step on a batch from ``place_batch``: ``(state,
        batch) -> (new state, metrics)``; the per-replica minibatch dim must
        divide ``accum_steps``."""
        if self.accum > 1:
            mb = next(iter(batch.values())).shape[1]
            if mb % self.accum:
                raise ValueError(
                    f"minibatch dim {mb} not divisible by "
                    f"accum_steps={self.accum}")
        grads, loss, mets = accumulate_grads(self.loss_fn, state.params,
                                             batch, self.accum)
        params, opt_state, om = self._opt_update(state.params, grads,
                                                 state.opt_state)
        return (TrainState(params, opt_state, state.step + 1, state.rng),
                self._unstack({**mets, **om, "loss": loss}))

    def eval_step(self, state: TrainState, batch: Batch) -> Dict:
        """Held-out metrics on the live state, no update: per-replica NSE and
        MSE for Dom-ST (scalars in single mode)."""
        if self.eval_fn is None:
            raise ValueError("engine was built without an eval_fn")
        with torch.no_grad():
            return self._unstack(self.eval_fn(state.params, batch))
