"""Carry parameters from the reference's layout into the port's.

The reference keeps Dom-ST parameters as a nested dict of arrays; its npz
checkpoints name each leaf by the '/'-joined key path
(``params/temporal/lstm0/wx``). The port keeps them as one flat dict with
the same key paths and the same leading watershed axis where the params
are stacked, and repacks the few leaves whose kernel takes another
layout:

* ``pixcon/w2`` (..., H, 1) -> (..., H), as the reference's Pix-Con
  wrapper reshapes it before the kernel;
* ``lstm<n>/wx``, ``wh`` (..., D, 4H) -> (..., D, 4, H) and ``b``
  (..., 4H) -> (..., 4, H), the LSTM kernel's gate-split layout
  (``kernels.lstm_cell.ops.split_gates``).

Only the trailing axes change, so stacked and unstacked leaves convert
alike.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.kernels.lstm_cell.ops import split_gates

_LSTM_LEAF = re.compile(r"(^|/)lstm\d+/(wx|wh|b)$")


def flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested dict -> flat dict keyed by '/'-joined key paths."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten(v, key))
        else:
            out[key] = v
    return out


def to_port_layout(key: str, arr: np.ndarray) -> np.ndarray:
    """Repack one leaf named ``key`` from the reference's layout."""
    if key == "pixcon/w2" or key.endswith("/pixcon/w2"):
        return arr.reshape(*arr.shape[:-2], arr.shape[-2])
    if _LSTM_LEAF.search(key):
        return split_gates(arr)
    return arr


def params_from_jax(tree: Mapping[str, Any], device: str | torch.device = "cpu"
                    ) -> Dict[str, torch.Tensor]:
    """Reference parameter tree (nested dict of numpy arrays, stacked or
    not) -> the port's flat dict of float32 tensors on ``device``."""
    return {k: torch.as_tensor(to_port_layout(k, np.array(v, np.float32)),
                               device=device).contiguous()
            for k, v in flatten(tree).items()}
