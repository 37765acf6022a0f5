"""Plain PyTorch version of the fused LSTM step (csrc/lstm_cell.cu).

Weight layout: wx (R,D,4,H), wh (R,H,4,H), b (R,4,H) with gate order
(i, f, g, o) and a leading replica axis R; forget bias +1 matches
core/temporal.py.
"""
from __future__ import annotations

from typing import Tuple

import torch


def lstm_cell_ref(x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                  wx: torch.Tensor, wh: torch.Tensor, b: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (R,B,D), h/c (R,B,H) -> (h', c') (R,B,H), fp32."""
    gates = (torch.einsum("rbd,rdgh->rbgh", x, wx)
             + torch.einsum("rbk,rkgh->rbgh", h, wh)
             + b[:, None])
    i, f, g, o = gates.unbind(-2)
    c_new = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new
