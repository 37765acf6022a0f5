"""The generalized contribution gate: the paper's Pix-Con idea lifted to
token stacks. A learned per-token weight in (0, 2), computed from the
token's own features, scales the residual stream after the embedding.
An optional feature of the LM archs (``cfg.contribution_gate``), never
on a published config. A copy of the reference's ``core/gating.py``.

It is not the Pix-Con kernel's function: it has no second bias, doubles
the weight, reads the token's d_model features themselves and never
normalises over tokens. The reference computes it in plain JAX, with no
Pallas kernel, and so does the port in plain PyTorch.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.distributed.sharding import constrain

HIDDEN = 64      # the reference's ``gate_params`` default


def gate_shapes(d_model: int) -> Dict[str, Tuple[tuple, str, None]]:
    """{leaf: (shape, init, scale)}, the reference's ``gate_params``."""
    return {"w1": ((d_model, HIDDEN), "normal", None),
            "b1": ((HIDDEN,), "zeros", None),
            "w2": ((HIDDEN, 1), "normal", None)}


def param_specs() -> Dict[str, tuple]:
    """Logical axes of each leaf, the reference's ``gate_params`` axes."""
    return {"w1": ("embed", "hidden"), "b1": ("hidden",),
            "w2": ("hidden", None)}


def contribution_gate(params, x: torch.Tensor,
                      temperature: float = 1.0) -> torch.Tensor:
    """x (B,S,d) -> x times its weight 2*sigmoid(s / temperature), 1 at
    s = 0. The score ``s = tanh(x w1 + b1) w2`` is computed in x's dtype,
    the weight in float32 and cast to x's dtype before the product, as the
    reference rounds them."""
    h = torch.tanh(x @ params["w1"].to(x.dtype) + params["b1"].to(x.dtype))
    s = (h @ params["w2"].to(x.dtype))[..., 0]
    w = 2.0 * torch.sigmoid(s.float() / temperature)
    return constrain(x * w[..., None].to(x.dtype), ("batch", "seq", "embed"))
