"""Plain PyTorch version of the causal depthwise conv1d kernel
(csrc/conv1d.cu).

It computes what the reference's Pallas kernel computes
(``repro/kernels/conv1d/kernel.py::_conv_kernel``): over the input
front-padded by K-1 rows,

    y[t] = silu?( b + sum_k w[k] * x[t - (K-1) + k] )

in float32, accumulated in the order k = 0..K-1 (each product rounded,
then added), the bias added last, and cast to x's dtype. The K-1 rows
before t = 0 are ``tail`` where one is given (the previous call's last
K-1 inputs, as the reference's model code carries between decode steps)
and zeros otherwise. Besides y it returns the new tail, the last K-1 rows
of ``[tail, x]``.

The reference's model code (``ssm._causal_conv``, ``rglru._conv``) sums
the products in x's dtype; in bfloat16 the two differ by a few ulps, in
float32 they agree.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

ACTIVATIONS = ("none", "silu")


def new_tail(x: torch.Tensor, tail: Optional[torch.Tensor],
             K: int) -> torch.Tensor:
    """The last K-1 rows of ``[tail (or zeros), x]`` along S: the tail the
    next call continues from."""
    B, S, C = x.shape
    if S >= K - 1:
        return x[:, S - (K - 1):]
    pad = tail.to(x.dtype) if tail is not None else x.new_zeros((B, K - 1, C))
    return torch.cat([pad, x], dim=1)[:, S:]


def tail_snapshots(x: torch.Tensor, tail: torch.Tensor,
                   K: int) -> torch.Tensor:
    """The tail after each of x's S tokens, the last K-1 rows of
    ``[tail, x[:, :t+1]]``, stacked on a leading S axis: (S, B, K-1, C)
    in x's dtype. A speculative verify step keeps them to roll back to."""
    full = torch.cat([tail.to(x.dtype), x], dim=1)
    return torch.stack([full[:, t + 1:t + K] for t in range(x.shape[1])])


def causal_conv1d_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                      activation: str = "none",
                      tail: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,C), w (K,C), b (C,), tail (B,K-1,C) or None -> (y (B,S,C)
    in x's dtype, new tail (B,K-1,C))."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation {activation!r} not in {ACTIVATIONS}")
    B, S, C = x.shape
    K = w.shape[0]
    pad = tail.to(x.dtype) if tail is not None else x.new_zeros((B, K - 1, C))
    xp = torch.cat([pad, x], dim=1).float()
    acc = torch.zeros((B, S, C), dtype=torch.float32, device=x.device)
    for k in range(K):
        acc = acc + xp[:, k:k + S] * w[k].float()
    acc = acc + b.float()
    if activation == "silu":
        acc = acc * torch.sigmoid(acc)
    return acc.to(x.dtype), new_tail(x, tail, K)
