"""Temporal block (paper Fig. 1c): stacked LSTM + final layers.

Receives the spatial block's features and — the paper's domain cue — the
*target day's* precipitation (+P) injected into the final layers. Each
LSTM step is one call of the fused cell, the Hopper kernel
``kernels/lstm_cell`` on the card; the reference's ``lax.scan`` over days
is a Python loop here. Weights are in the kernel layout wx (R,D,4,H),
wh (R,H,4,H), b (R,4,H), gates i|f|g|o, forget bias +1.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import DomSTConfig
from repro_torch.distributed import sharding as shd
from repro_torch.kernels.lstm_cell.ops import lstm_cell_fused


def lstm_cell_params(in_dim: int, hidden: int):
    """Unstacked leaf shapes and inits, in the reference's packed layout."""
    return {
        "wx": ((in_dim, 4 * hidden), "normal"),
        "wh": ((hidden, 4 * hidden), "normal"),
        "b": ((4 * hidden,), "zeros"),
    }


def temporal_params(dc: DomSTConfig, in_dim: int):
    p = {}
    dim = in_dim
    for layer in range(dc.lstm_layers):
        for k, v in lstm_cell_params(dim, dc.lstm_hidden).items():
            p[f"lstm{layer}/{k}"] = v
        dim = dc.lstm_hidden
    head_in = dc.lstm_hidden + (dc.num_pixels if dc.use_target_day else 0)
    p["fc1"] = ((head_in, dc.mlp_hidden), "normal")
    p["fc1_b"] = ((dc.mlp_hidden,), "zeros")
    p["fc2"] = ((dc.mlp_hidden, 1), "normal")
    p["fc2_b"] = ((1,), "zeros")
    return p


def param_specs(dc: DomSTConfig):
    """Logical axes of each leaf, in the kernel's gate-split layout: the
    reference's packed 4H axis (``"hidden"``) becomes (None, ``"hidden"``),
    so a shard holds every gate of its hidden units."""
    p = {}
    for layer in range(dc.lstm_layers):
        p[f"lstm{layer}/wx"] = (None, None, "hidden")
        p[f"lstm{layer}/wh"] = ("hidden", None, "hidden")
        p[f"lstm{layer}/b"] = (None, "hidden")
    p.update({"fc1": (None, "hidden"), "fc1_b": ("hidden",),
              "fc2": ("hidden", None), "fc2_b": (None,)})
    return p


def lstm_cell(params: Dict[str, torch.Tensor], x_t: torch.Tensor,
              h: torch.Tensor, c: torch.Tensor, *,
              cell: Callable = lstm_cell_fused
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM step. x_t (R,B,D), h/c (R,B,H) -> (h', c')."""
    return cell(x_t, h, c, params["wx"], params["wh"], params["b"])


def lstm_layer(x: torch.Tensor, wx: torch.Tensor, wh: torch.Tensor,
               b: torch.Tensor, *, cell: Callable = lstm_cell_fused
               ) -> torch.Tensor:
    """One LSTM layer over the days: x (R,B,T,D) -> hidden states (R,B,T,H),
    one fused-cell call a day."""
    lp = {"wx": wx, "wh": wh, "b": b}
    R, B, T, _ = x.shape
    h = x.new_zeros((R, B, wh.shape[1]))
    c = torch.zeros_like(h)
    xs = x.permute(2, 0, 1, 3).contiguous()                     # (T,R,B,D)
    hs = []
    for t in range(T):
        h, c = lstm_cell(lp, xs[t], h, c, cell=cell)
        hs.append(h)
    return torch.stack(hs, dim=2)                               # (R,B,T,H)


def temporal_block(params: Dict[str, torch.Tensor], dc: DomSTConfig,
                   feats: torch.Tensor, target_day: Optional[torch.Tensor],
                   *, cell: Callable = lstm_cell_fused) -> torch.Tensor:
    """feats (R,B,T,F), target_day (R,B,P) or None -> discharge (R,B).
    On a mesh each layer's steps run on local blocks (``local_rows``)."""
    x = feats
    for layer in range(dc.lstm_layers):
        lp = [params[f"lstm{layer}/{k}"] for k in ("wx", "wh", "b")]
        run = functools.partial(lstm_layer, cell=cell)
        x = (shd.local_rows(run, [x], lp) if shd.is_distributed(x)
             else run(x, *lp))
    h = x[:, :, -1]                                             # last hidden
    if dc.use_target_day and target_day is not None:
        h = torch.cat([h, target_day], dim=-1)                  # the (+P) cue
    z = torch.tanh(h @ params["fc1"] + params["fc1_b"][:, None, :])
    return (z @ params["fc2"] + params["fc2_b"][:, None, :])[..., 0]
