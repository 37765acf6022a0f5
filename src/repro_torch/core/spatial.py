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
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import constrain


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


def param_specs():
    """Logical axes of each leaf: the reference's ``spatial_params`` axes,
    heads on the paper's head-partitioning axis."""
    return {"conv_w": ("pix_heads", "conv", "pixels", None),
            "conv_b": ("pix_heads", None),
            "conv2_w": ("pix_heads", "conv", None, None),
            "conv2_b": ("pix_heads", None)}


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


def _heads(parts, conv_w, conv_b, conv2_w, conv2_b):
    h = torch.relu(_conv1d_same(parts, conv_w, conv_b))
    return torch.relu(_conv1d_same(h, conv2_w, conv2_b))


def _heads_on_mesh(parts, weights):
    """``_heads`` on each rank's block of replicas (or minibatch) and heads;
    a weight is split where the parts' replica (dim 0) or head (dim 2)
    axis is, whole elsewhere, and its gradient Partial over a batch split
    of the minibatch."""
    from torch.distributed.tensor import Replicate, Shard
    at = tuple(p if isinstance(p, Shard) and p.dim in (0, 1, 2)
               else Replicate() for p in parts.placements)
    wt = tuple(Shard(0) if p == Shard(0) else Shard(1) if p == Shard(2)
               else Replicate() for p in at)
    grads = [at] + [shd.weight_grad_placements(wt, at)] * 4
    return shd.local_kernel(_heads, [parts, *weights], [at] + [wt] * 4,
                            [at], grads=grads)


def spatial_block(params: Dict[str, torch.Tensor], dc: DomSTConfig,
                  parts: torch.Tensor) -> torch.Tensor:
    """parts (R,B,G,T,P/G) -> features (R,B,T,G*C). On a mesh the heads
    sit on "model" (``pix_heads``) and the replica axis, else the
    minibatch axis, on the batch axes: "batch" names both, and the
    resolver gives the mesh axes to the first that they divide. Each
    head's convs are its own, so they run on local blocks
    (``local_map``): the weights follow the replica and head splits."""
    axes = ("batch", "batch", "pix_heads", "time", None)
    parts = constrain(parts, axes)
    w = [params[k] for k in ("conv_w", "conv_b", "conv2_w", "conv2_b")]
    if shd.is_distributed(parts):
        h = _heads_on_mesh(parts, w)
    else:
        h = _heads(parts, *w)
    h = constrain(h, axes)                     # the per-head features
    R, B, G, T, C = h.shape
    return h.transpose(2, 3).reshape(R, B, T, G * C)
