"""Spatial block (paper Fig. 1b): multi-headed multi-channel 1D-CNN.

Each head consumes one pixel partition and runs a multichannel temporal 1D
conv over its pixels. Heads sit on a leading head axis, behind the replica
and batch axes, and each conv is K shifted fp32 matrix products, as in the
reference. This is a dense channel-mixing SAME conv: the depthwise causal
conv of ``kernels/conv1d`` in the reference is a different op (its
``core/spatial.py`` docstring says otherwise), so this module has no
kernel of its own and does not go through cuDNN.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import DomSTConfig


def spatial_params(dc: DomSTConfig):
    """Unstacked leaf shapes and inits, in the reference's layout."""
    pix_per_head = dc.num_pixels // dc.num_heads
    G, K, C = dc.num_heads, dc.kernel_size, dc.cnn_channels
    return {
        # (G, K, P/G, C): per-head temporal conv, pixel channels -> C features
        "conv_w": ((G, K, pix_per_head, C), "normal"),
        "conv_b": ((G, C), "zeros"),
        "conv2_w": ((G, K, C, C), "normal"),
        "conv2_b": ((G, C), "zeros"),
    }


def _conv1d_same(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """x (R,B,G,T,Cin), w (R,G,K,Cin,Cout), b (R,G,Cout) -> (R,B,G,T,Cout),
    SAME padding (left pad (K-1)//2)."""
    K = w.shape[2]
    T = x.shape[-2]
    pad_l = (K - 1) // 2
    xp = F.pad(x, (0, 0, pad_l, K - 1 - pad_l))
    out = torch.einsum("rbgtc,rgco->rbgto", xp[..., 0:T, :], w[:, :, 0])
    for i in range(1, K):
        out = out + torch.einsum("rbgtc,rgco->rbgto", xp[..., i:i + T, :],
                                 w[:, :, i])
    return out + b[:, None, :, None, :]


def spatial_block(params: Dict[str, torch.Tensor], dc: DomSTConfig,
                  parts: torch.Tensor) -> torch.Tensor:
    """parts (R,B,G,T,P/G) -> features (R,B,T,G*C)."""
    h = torch.relu(_conv1d_same(parts, params["conv_w"], params["conv_b"]))
    h = torch.relu(_conv1d_same(h, params["conv2_w"], params["conv2_b"]))
    R, B, G, T, C = h.shape
    return h.transpose(2, 3).reshape(R, B, T, G * C)
