"""Shared layers: norms, rotary embeddings, embedding tables, softcap.

The port of ``repro/models/layers.py``. Weights arrive in the activation
dtype or in float32; each function casts at use as the reference does
(a cast to the dtype a tensor already has is free). Norm scales are
always read in float32.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional

import numpy as np
import torch

NEG_INF = -1e30


def apply_norm(params, kind: str, x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.float()
    if kind == "rmsnorm":
        var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
        y = x32 * torch.rsqrt(var + eps)
        y = y * params["scale"].float()
    elif kind in ("layernorm", "nonparam_ln"):
        mean = torch.mean(x32, dim=-1, keepdim=True)
        var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
        y = (x32 - mean) * torch.rsqrt(var + eps)
        if kind == "layernorm":
            y = y * params["scale"].float() + params["bias"].float()
    else:
        raise ValueError(kind)
    return y.to(dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """gemma2 logit soft-capping: cap * tanh(x / cap)."""
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


@lru_cache(maxsize=None)
def _freqs_on(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """``rope_freqs`` as a tensor on ``device``, made once per (D, theta,
    device): a table built per call would cost a host-to-device copy in
    every layer of every step."""
    return torch.from_numpy(rope_freqs(head_dim, theta)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, D) with positions (..., S) or (S,)."""
    freqs = _freqs_on(x.shape[-1], float(theta), x.device)     # (D/2,)
    angles = positions[..., None].float() * freqs              # (..., S, D/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
def embed(params, tokens: torch.Tensor, *, scale: bool, d_model: int,
          dtype: torch.dtype) -> torch.Tensor:
    x = params["embedding"][tokens.long()].to(dtype)
    if scale:
        x = x * torch.tensor(math.sqrt(d_model), dtype=dtype, device=x.device)
    return x


def unembed(params, x: torch.Tensor, *, tie: bool, cap: float = 0.0,
            real_vocab: Optional[int] = None) -> torch.Tensor:
    """(..., d) -> float32 logits (..., padded vocab); the vocab-padding
    columns read -1e30, so softmax and argmax never select them."""
    if tie:
        logits = x @ params["embedding"].to(x.dtype).t()
    else:
        logits = x @ params["unembed"].to(x.dtype)
    logits = softcap(logits.float(), cap)
    pv = logits.shape[-1]
    if real_vocab is not None and real_vocab < pv:
        col = torch.arange(pv, device=logits.device)
        logits = torch.where(col < real_vocab, logits, NEG_INF)
    return logits
