"""TrainState: everything a training run needs to resume — parameters,
optimizer state, the engine's step counter and the rng leaf — as one
object, checkpointed as one file (``checkpoint.save``).

Parameters are the port's flat dict (key paths of the reference, every
leaf with a leading replica axis R; single mode is R=1), so the optimizer
state is per replica too (``OptState.step`` is (R,)).

The rng leaf. The reference stores JAX key data — uint32 of shape (2,),
or (R, 2) when stacked — and folds it every step. PyTorch cannot
reproduce JAX's threefry stream, and Dom-ST training draws no randomness,
so the port keeps the leaf opaque: uint32 of the reference's shape, drawn
from a ``torch.Generator`` seeded by ``tc.seed`` for a fresh state, or
carried over unchanged from a restored checkpoint, and never advanced. It
exists so that each package's checkpoint restores in the other, and its
shape tells a stacked state ((R, 2)) from a single one ((2,)). Parity
checks compare params, moments and steps, never ``rng``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.optim import OptState, make_optimizer
from repro_torch.optim.optimizer import Tree


class TrainState(NamedTuple):
    params: Tree
    opt_state: OptState
    step: torch.Tensor       # engine-level step counter, int32 scalar
    rng: torch.Tensor        # opaque uint32 (2,), or (R, 2) when stacked


def new_rng(tc: TrainConfig, replicas: int, stacked: bool) -> torch.Tensor:
    """A fresh rng leaf of the reference's shape, from ``tc.seed``."""
    shape = (replicas, 2) if stacked else (2,)
    g = torch.Generator().manual_seed(tc.seed)
    bits = torch.randint(0, 2 ** 32, shape, generator=g, dtype=torch.int64)
    return torch.from_numpy(bits.numpy().astype(np.uint32))


def new_train_state(params: Tree, tc: TrainConfig, *,
                    stacked: bool = False) -> TrainState:
    """Fresh state around ``params`` (leading replica axis R; R=1 unless
    ``stacked``)."""
    replicas = next(iter(params.values())).shape[0]
    if not stacked and replicas != 1:
        raise ValueError(f"single mode takes one replica, got R={replicas}")
    opt_init, _ = make_optimizer(tc)
    dev = next(iter(params.values())).device
    return TrainState(params=params, opt_state=opt_init(params),
                      step=torch.zeros((), dtype=torch.int32, device=dev),
                      rng=new_rng(tc, replicas, stacked))
