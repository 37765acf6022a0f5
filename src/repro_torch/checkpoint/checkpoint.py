"""Read the reference's npz checkpoints into the port's parameters.

The reference writes one npz entry per leaf, named by its '/'-joined key
path (``params/temporal/lstm0/wx``). Restoring goes through an *example*
flat dict in the port's layout (the usual restore-into-init pattern): each
entry is read, repacked by ``convert.to_port_layout`` and checked against
the example's shape, so one checkpoint file drives both packages.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.convert import to_port_layout


def restore_subtree(path: str, example: Dict[str, torch.Tensor],
                    prefix: str) -> Dict[str, torch.Tensor]:
    """Restore the entries under ``prefix/`` into ``example``'s keys,
    dtypes and devices. Lets the forecaster rebuild the ``params`` branch
    of a full training-state checkpoint without the optimizer moments.
    ``prefix=""`` restores the whole file."""
    pre = f"{prefix}/" if prefix else ""
    out = {}
    with np.load(path) as data:
        for key, ex in example.items():
            name = pre + key
            if name not in data:
                raise KeyError(f"checkpoint missing '{name}'")
            arr = to_port_layout(key, data[name])
            if tuple(arr.shape) != tuple(ex.shape):
                raise ValueError(f"shape mismatch for '{name}': ckpt "
                                 f"{arr.shape} vs example {tuple(ex.shape)}")
            out[key] = torch.as_tensor(arr, dtype=ex.dtype,
                                       device=ex.device).contiguous()
    return out
