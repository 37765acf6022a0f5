"""Gated MLP (SwiGLU / GEGLU): the port of ``repro/models/mlp.py``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import constrain


def mlp_shapes(d_model: int, d_ff: int):
    """{leaf: (shape, init, scale)} of the gated MLP, the reference's
    ``mlp_params`` (every leaf by the fan-in rule)."""
    return {"w_gate": ((d_model, d_ff), "normal", None),
            "w_up": ((d_model, d_ff), "normal", None),
            "w_down": ((d_ff, d_model), "normal", None)}


def param_specs():
    """Logical axes of each leaf, the reference's ``mlp_params`` axes."""
    return {"w_gate": ("embed", "ffn"), "w_up": ("embed", "ffn"),
            "w_down": ("ffn", "embed")}


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown act '{kind}'")


def mlp_block(params, cfg_or_act, x: torch.Tensor) -> torch.Tensor:
    """x (B,S,d) -> (B,S,d). Accepts a ModelConfig or an act-name string."""
    act = cfg_or_act.act if isinstance(cfg_or_act, ModelConfig) else cfg_or_act
    g = x @ params["w_gate"].to(x.dtype)
    u = x @ params["w_up"].to(x.dtype)
    h = constrain(_act(g, act) * u, ("batch", "seq", "ffn"))
    return constrain(h @ params["w_down"].to(x.dtype), ("batch", "seq", "embed"))
