"""Gated MLP (SwiGLU / GEGLU): the port of ``repro/models/mlp.py``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


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
    return (_act(g, act) * u) @ params["w_down"].to(x.dtype)
