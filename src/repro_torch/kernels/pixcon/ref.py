"""Plain PyTorch version of the fused Pix-Con gate (csrc/pixcon.cu).

The wrapper in ``ops.py`` uses it for tensors on the CPU, and the checks on
the card hold the kernel against it. Its sums (the two small
contractions and the normalising sum over pixels) are written out in
index order, the order and rounding the kernel uses, so that on the card
the two give the same ``w`` to the bit: the partitioner ranks pixels by
``w``, and neighbouring weights often lie only a few ulp apart.
"""
from __future__ import annotations

from typing import Tuple

import torch


def pixcon_gate_ref(x: torch.Tensor, feats: torch.Tensor, w1: torch.Tensor,
                    b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor, *,
                    temperature: float = 1.0, normalize: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (R,B,T,P), feats (R,B,P,F); per-replica MLP weights w1 (R,F,Hp),
    b1 (R,Hp), w2 (R,Hp), b2 (R,1).

    score = tanh(feats @ w1 + b1) @ w2 + b2
    w     = sigmoid(score / temperature)     [optionally sum-normalized * P]
    out   = x * w[..., None, :]

    Returns (out (R,B,T,P), w (R,B,P)).
    """
    w1 = w1[:, None, None]                                      # (R,1,1,F,Hp)
    a = feats[..., 0, None] * w1[..., 0, :]
    for f in range(1, feats.shape[-1]):
        a = a + feats[..., f, None] * w1[..., f, :]
    h = torch.tanh(a + b1[:, None, None, :])                    # (R,B,P,Hp)
    w2 = w2[:, None, None, :]
    s = h[..., 0] * w2[..., 0]
    for k in range(1, h.shape[-1]):
        s = s + h[..., k] * w2[..., k]
    w = torch.sigmoid((s + b2[:, None, :]) * (1.0 / temperature))  # (R,B,P)
    if normalize:
        total = w[..., 0:1]
        for p in range(1, w.shape[-1]):
            total = total + w[..., p:p + 1]
        w = w * (w.shape[-1] / torch.clamp_min(total, 1e-6))
    return x * w[..., None, :], w
