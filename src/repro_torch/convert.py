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
alike; :func:`from_port_layout` repacks a leaf back, for the checkpoints
the port writes in the reference's layout.

An LM tree (one with an ``embed`` subtree) converts by
:func:`lm_params_from_jax`: the reference scans a ``blocks`` subtree whose
leaves carry a leading layer-repetition axis, and the port keeps one
nested dict per layer, so that axis is unstacked into the list
``layers`` (prefix layers, the repetitions pattern by pattern, then the
suffix). Leaves keep the reference's shapes and names, in the attention
(``attn``, with qwen3's ``q_norm``/``k_norm``), RG-LRU (``rec``), SSM
(``ssm``, with its nested ``out_norm``) and FFN subtrees alike; a MoE
FFN keeps its ``router``, its experts stacked on a leading expert axis
(``w_gate``, ``w_up``, ``w_down``) and its ``shared`` MLP, and
deepseek-moe's dense first layer comes from ``prefix``. The contribution
gate (``gate``: ``w1``, ``b1``, ``w2``) and a front end (``frontend``:
the audio stub's ``proj``/``proj_b``, the vision stub's ``w1``, ``b1``,
``w2``, ``b2``) are not stacked and carry over as they are.
:func:`lm_params_to_jax` is its inverse, which restacks the repetitions
for the checkpoints the port writes in the reference's layout.

The LM training engine keeps the per-layer tree flat, as the Dom-ST
params are: :func:`flatten` keys each leaf by its '/'-joined path
(``layers/3/attn/wq``) and :func:`unflatten` rebuilds the tree from such
a dict on the model's structure.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.kernels.lstm_cell.ops import split_gates

_LSTM_LEAF = re.compile(r"(^|/)lstm\d+/(wx|wh|b)$")
# an LM tree's subtrees outside the layer stack, beside the embedding
_UNSTACKED = ("gate", "frontend")


def flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested dict (lists as their indices) -> flat dict keyed by
    '/'-joined key paths."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, (list, tuple)):
            v = {str(i): e for i, e in enumerate(v)}
        if isinstance(v, Mapping):
            out.update(flatten(v, key))
        else:
            out[key] = v
    return out


def unflatten(flat: Mapping[str, Any], like: Any) -> Any:
    """The inverse of :func:`flatten`: the tree of ``like`` (a tree of the
    same structure with any leaves, as ``transformer.model_params(cfg,
    lambda *a: None)`` gives an LM's) with its leaves taken from ``flat``.
    Groups without leaves (a non-affine norm's ``{}``) are kept."""
    def fill(t, key):
        if isinstance(t, Mapping):
            return {k: fill(v, f"{key}{k}/") for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [fill(v, f"{key}{i}/") for i, v in enumerate(t)]
        return flat[key[:-1]]
    return fill(like, "")


def to_port_layout(key: str, arr: np.ndarray) -> np.ndarray:
    """Repack one leaf named ``key`` from the reference's layout."""
    if key == "pixcon/w2" or key.endswith("/pixcon/w2"):
        return arr.reshape(*arr.shape[:-2], arr.shape[-2])
    if _LSTM_LEAF.search(key):
        return split_gates(arr)
    return arr


def from_port_layout(key: str, arr: np.ndarray) -> np.ndarray:
    """The inverse of :func:`to_port_layout`: one leaf named ``key`` back
    in the reference's layout."""
    if key == "pixcon/w2" or key.endswith("/pixcon/w2"):
        return arr.reshape(*arr.shape, 1)
    if _LSTM_LEAF.search(key):
        return arr.reshape(*arr.shape[:-2], arr.shape[-2] * arr.shape[-1])
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
    """Reference LM tree (``embed``, ``final_norm``, optional ``gate`` and
    ``frontend``, optional ``prefix`` / ``suffix`` tuples, ``blocks``
    stacked over repetitions) -> ``{"embed", "final_norm", ["gate",]
    ["frontend",] "layers": [per-layer dict, ...]}`` of float32
    tensors."""
    def leaf(v):
        return torch.as_tensor(np.array(v, np.float32), device=device).contiguous()

    def nested(t, at=leaf):
        return {k: nested(v, at) if isinstance(v, Mapping) else at(v)
                for k, v in t.items()}

    unknown = set(tree) - {"embed", "final_norm", "prefix", "blocks",
                           "suffix", *_UNSTACKED}
    if unknown:
        raise ValueError(f"LM params with unknown subtrees {sorted(unknown)}")
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
    out = {"embed": nested(tree["embed"]),
           "final_norm": nested(tree["final_norm"])}
    out.update({k: nested(tree[k]) for k in _UNSTACKED if k in tree})
    out["layers"] = layers
    return out


def lm_params_to_jax(params: Mapping[str, Any], cfg) -> Dict[str, Any]:
    """The inverse of :func:`lm_params_from_jax`: the port's per-layer tree
    (tensors or arrays) -> the reference's nested dict of float32 numpy
    arrays, ``prefix`` and ``suffix`` tuples and ``blocks`` stacked over
    the repetitions, as ``cfg``'s stack plan lays them out."""
    from repro_torch.models.transformer import stack_plan

    def arr(t):
        if isinstance(t, torch.Tensor):
            t = t.detach().cpu().numpy()
        return np.asarray(t, np.float32)

    def nested(t):
        return {k: nested(v) if isinstance(v, Mapping) else arr(v)
                for k, v in t.items()}

    def stacked(trees):
        if isinstance(trees[0], Mapping):
            return {k: stacked([t[k] for t in trees]) for k in trees[0]}
        return np.stack([arr(t) for t in trees])

    prefix, pat, n_rep, suffix = stack_plan(cfg)
    layers = list(params["layers"])
    if len(layers) != len(prefix) + n_rep * len(pat) + len(suffix):
        raise ValueError(f"{len(layers)} layers do not fit {cfg.name}'s "
                         "stack plan")
    out: Dict[str, Any] = {"embed": nested(params["embed"]),
                           "final_norm": nested(params["final_norm"])}
    out.update({k: nested(params[k]) for k in _UNSTACKED if k in params})
    if prefix:
        out["prefix"] = tuple(nested(lp) for lp in layers[:len(prefix)])
    if n_rep:
        body = layers[len(prefix):len(prefix) + n_rep * len(pat)]
        out["blocks"] = {str(i): stacked(body[i::len(pat)])
                         for i in range(len(pat))}
    if suffix:
        out["suffix"] = tuple(nested(lp) for lp in layers[len(layers)
                                                          - len(suffix):])
    return out
