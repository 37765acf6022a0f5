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
An LM's ``params`` restore from the reference's key paths (its scanned
``blocks`` stacked over the repetitions) into the port's per-layer tree
(``restore_lm_params``). An LM training state (``save`` and ``restore``
given the model's config) keeps its params and moments flat, keyed by the
port's per-layer paths (``layers/3/attn/wq``); they are written under the
reference's paths, each repetition of the layer pattern stacked into
``blocks`` (``convert.lm_params_to_jax``), and read back through
``restore_lm_params``, so an LM checkpoint also crosses packages.
"""
from __future__ import annotations

import os
import tempfile
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.convert import (
    flatten, from_port_layout, lm_params_from_jax, lm_params_to_jax,
    to_port_layout, unflatten,
)

# a ``repro_torch.train.TrainState``; not imported, since the training
# engine imports this module
TrainState = Any


def _entries(state: TrainState, cfg=None) -> Dict[str, np.ndarray]:
    """npz name -> array in the reference's layout; ``cfg``, an LM's
    config, restacks its flat per-layer trees into ``blocks``."""
    single = state.rng.dim() == 1

    def leaf(key, t):
        a = t.detach().cpu().numpy()
        return from_port_layout(key, a[0] if single else a)

    def tree(prefix, flat):
        if cfg is None:
            return {f"{prefix}/{k}": leaf(k, v) for k, v in flat.items()}
        jtree = lm_params_to_jax(unflatten(
            {k: v[0] if single else v for k, v in flat.items()},
            _structure(cfg)), cfg)
        return {f"{prefix}/{k}": v for k, v in flatten(jtree).items()}

    opt = state.opt_state
    out = tree("params", state.params)
    out.update(tree("opt_state/mu", opt.mu))
    if opt.nu:
        out.update(tree("opt_state/nu", opt.nu))
    out["opt_state/step"] = leaf("", opt.step)
    out["step"] = state.step.detach().cpu().numpy()
    out["rng"] = state.rng.detach().cpu().numpy()
    return out


def _structure(cfg):
    """The LM param tree of ``cfg`` with no leaves: what ``unflatten``
    rebuilds the flat state's trees on."""
    from repro_torch.models.transformer import model_params
    return model_params(cfg, lambda *a: None)


def save(path: str, state: TrainState, cfg=None) -> None:
    """Write ``state`` to ``path`` atomically (a temporary file in the same
    directory, then a rename). An LM state needs its model's ``cfg``."""
    arrays = _entries(state, cfg)
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


def restore(path: str, example: TrainState, cfg=None) -> TrainState:
    """Restore a full training state (either package's) into ``example``'s
    keys, shapes, dtypes and devices. An LM state needs its model's
    ``cfg``: its params and moments are read through
    ``restore_lm_params``."""
    single = example.rng.dim() == 1
    opt = example.opt_state

    def lm_tree(prefix, ex):
        if not single:
            raise ValueError("an LM training state has no replica axis")
        got = restore_lm_params(path, unflatten(
            {k: v[0] for k, v in ex.items()}, _structure(cfg)), prefix)
        return {k: v[None] for k, v in flatten(got).items()}

    with np.load(path) as data:
        def tree(prefix, ex):
            if cfg is not None:
                return lm_tree(prefix, ex) if ex else {}
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


def restore_lm_params(path: str, example: Dict[str, Any],
                      prefix: str) -> Dict[str, Any]:
    """The reference's LM params under ``prefix/`` (``embed/...``,
    ``final_norm/...``, ``blocks/<i>/...`` stacked over the repetitions,
    ``prefix/<j>/...``, ``suffix/<j>/...``) unstacked into the port's
    per-layer tree (``example``, as ``transformer.init`` builds it) by
    ``convert.lm_params_from_jax``, then shaped, typed and placed as
    ``example``. ``prefix=""`` reads the whole file."""
    pre = f"{prefix}/" if prefix else ""
    tree: Dict[str, Any] = {}
    with np.load(path) as data:
        for name in data.files:
            if not name.startswith(pre):
                continue
            node = tree
            parts = name[len(pre):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[name]
    for group in ("prefix", "suffix"):
        if group in tree:
            tree[group] = [tree[group][k] for k in sorted(tree[group], key=int)]
    got = lm_params_from_jax(tree)

    def place(g, ex, where):
        if isinstance(ex, dict):
            missing = set(ex) - set(g)
            if missing:
                raise KeyError(f"checkpoint missing '{pre}{where}"
                               f"{sorted(missing)[0]}'")
            return {k: place(g[k], v, f"{where}{k}/") for k, v in ex.items()}
        if isinstance(ex, list):
            if len(g) != len(ex):
                raise ValueError(f"checkpoint has {len(g)} layers, the "
                                 f"example {len(ex)}")
            return [place(a, b, f"{where}{i}/") for i, (a, b) in
                    enumerate(zip(g, ex))]
        if tuple(g.shape) != tuple(ex.shape):
            raise ValueError(f"shape mismatch for '{pre}{where[:-1]}': ckpt "
                             f"{tuple(g.shape)} vs example {tuple(ex.shape)}")
        return g.to(dtype=ex.dtype, device=ex.device).contiguous()
    return place(got, example, "")
