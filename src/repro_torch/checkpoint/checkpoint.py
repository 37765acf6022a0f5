"""npz checkpoints in the reference's layout, read and written.

The reference writes one npz entry per leaf of its TrainState, named by
its '/'-joined key path: ``params/temporal/lstm0/wx``, ``opt_state/step``,
``opt_state/mu/...``, ``opt_state/nu/...`` (none for SGD), ``step`` and
``rng``. The port writes the same entries, each leaf repacked into the
reference's layout by ``convert.from_port_layout``; a single-mode state
(rng of shape (2,)) drops the port's leading replica axis R=1, as the
reference's unstacked state has none. Restoring goes through an
*example* in the port's layout (the usual restore-into-init pattern):
each entry is read, repacked by ``convert.to_port_layout`` and checked
against the example's shape, so one checkpoint file drives both packages.
"""
from __future__ import annotations

import os
import tempfile
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.convert import from_port_layout, to_port_layout

# a ``repro_torch.train.TrainState``; not imported, since the training
# engine imports this module
TrainState = Any


def _entries(state: TrainState) -> Dict[str, np.ndarray]:
    """npz name -> array in the reference's layout."""
    single = state.rng.dim() == 1

    def leaf(key, t):
        a = t.detach().cpu().numpy()
        return from_port_layout(key, a[0] if single else a)

    opt = state.opt_state
    out = {f"params/{k}": leaf(k, v) for k, v in state.params.items()}
    out.update({f"opt_state/mu/{k}": leaf(k, v) for k, v in opt.mu.items()})
    out.update({f"opt_state/nu/{k}": leaf(k, v) for k, v in opt.nu.items()})
    out["opt_state/step"] = leaf("", opt.step)
    out["step"] = state.step.detach().cpu().numpy()
    out["rng"] = state.rng.detach().cpu().numpy()
    return out


def save(path: str, state: TrainState) -> None:
    """Write ``state`` to ``path`` atomically (a temporary file in the same
    directory, then a rename)."""
    arrays = _entries(state)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _read(data, name: str, key: str, ex: torch.Tensor,
          single: bool) -> torch.Tensor:
    """Entry ``name`` in the port's layout (leaf ``key``), shaped, typed and
    placed as ``ex``."""
    if name not in data:
        raise KeyError(f"checkpoint missing '{name}'")
    arr = data[name]
    arr = to_port_layout(key, arr[None] if single else arr)
    if tuple(arr.shape) != tuple(ex.shape):
        raise ValueError(f"shape mismatch for '{name}': ckpt {arr.shape} vs "
                         f"example {tuple(ex.shape)}")
    return torch.as_tensor(arr, dtype=ex.dtype, device=ex.device).contiguous()


def restore(path: str, example: TrainState) -> TrainState:
    """Restore a full training state (either package's) into ``example``'s
    keys, shapes, dtypes and devices."""
    single = example.rng.dim() == 1
    opt = example.opt_state
    with np.load(path) as data:
        def tree(prefix, ex):
            return {k: _read(data, f"{prefix}/{k}", k, v, single)
                    for k, v in ex.items()}
        return example._replace(
            params=tree("params", example.params),
            opt_state=opt._replace(
                step=_read(data, "opt_state/step", "", opt.step, single),
                mu=tree("opt_state/mu", opt.mu),
                nu=tree("opt_state/nu", opt.nu)),
            step=_read(data, "step", "", example.step, False),
            rng=_read(data, "rng", "", example.rng, False))


def restore_subtree(path: str, example: Dict[str, torch.Tensor],
                    prefix: str) -> Dict[str, torch.Tensor]:
    """Restore the entries under ``prefix/`` into ``example``'s keys,
    dtypes and devices. Lets the forecaster rebuild the ``params`` branch
    of a full training-state checkpoint without the optimizer moments.
    ``prefix=""`` restores the whole file."""
    pre = f"{prefix}/" if prefix else ""
    with np.load(path) as data:
        return {key: _read(data, pre + key, key, ex, False)
                for key, ex in example.items()}
