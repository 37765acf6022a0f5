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

An LM tree (one with an ``embed`` subtree) converts by
:func:`lm_params_from_jax`: the reference scans a ``blocks`` subtree whose
leaves carry a leading layer-repetition axis, and the port keeps one
nested dict per layer, so that axis is unstacked into the list
``layers`` (prefix layers, the repetitions pattern by pattern, then the
suffix). Leaves keep the reference's shapes and names, in the attention
(``attn``), RG-LRU (``rec``), SSM (``ssm``, with its nested
``out_norm``) and FFN subtrees alike.
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
                    ) -> Dict[str, Any]:
    """Reference parameter tree (nested dict of numpy arrays) -> the port's
    float32 tensors on ``device``: for Dom-ST (stacked or not) a flat dict
    keyed by path, for an LM the per-layer tree of
    :func:`lm_params_from_jax`."""
    if "embed" in tree:
        return lm_params_from_jax(tree, device)
    return {k: torch.as_tensor(to_port_layout(k, np.array(v, np.float32)),
                               device=device).contiguous()
            for k, v in flatten(tree).items()}


def lm_params_from_jax(tree: Mapping[str, Any],
                       device: str | torch.device = "cpu") -> Dict[str, Any]:
    """Reference LM tree (``embed``, ``final_norm``, optional ``prefix`` /
    ``suffix`` tuples, ``blocks`` stacked over repetitions) -> ``{"embed",
    "final_norm", "layers": [per-layer dict, ...]}`` of float32 tensors."""
    def leaf(v):
        return torch.as_tensor(np.array(v, np.float32), device=device).contiguous()

    def nested(t, at=leaf):
        return {k: nested(v, at) if isinstance(v, Mapping) else at(v)
                for k, v in t.items()}

    unknown = set(tree) - {"embed", "final_norm", "prefix", "blocks", "suffix"}
    if unknown:
        raise NotImplementedError(
            f"LM params with {sorted(unknown)} are not ported")
    layers = [nested(lp) for lp in tree.get("prefix", ())]
    if "blocks" in tree:
        blocks = tree["blocks"]
        pattern = sorted(blocks, key=int)
        n_rep = len(np.asarray(next(iter(flatten(blocks[pattern[0]]).values()))))
        for r in range(n_rep):
            for i in pattern:
                layers.append(nested(blocks[i], lambda a: leaf(
                    np.asarray(a)[r])))
    layers += [nested(lp) for lp in tree.get("suffix", ())]
    return {"embed": nested(tree["embed"]),
            "final_norm": nested(tree["final_norm"]), "layers": layers}
