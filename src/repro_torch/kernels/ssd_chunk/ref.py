"""Plain PyTorch version of the SSD intra-chunk kernel (csrc/ssd_chunk.cu).

It computes what the reference's Pallas kernel computes
(``repro/kernels/ssd_chunk/kernel.py::_ssd_kernel``), steps 1-2 of the
Mamba-2 dual form, per (batch, chunk, head), all in float32:

    L[i,j]   = exp(dA_cs[i] - dA_cs[j])  for i >= j, else 0
    y_diag   = ((C @ B^T) * L) @ xdt                     (Q, P)
    state    = xdt^T @ (B * exp(dA_cs[-1] - dA_cs)[:, None])   (P, N)

with y_diag cast to xdt's dtype and the state kept in float32. The upper
triangle is selected away, never multiplied: exp of a positive segment
sum can overflow to inf, and inf * 0 is NaN.

The reference's model code (``ssm.ssd_chunked``) rounds C @ B^T * L and
the state's product through the activation dtype; in bfloat16 the two
differ by a few ulps, in float32 they agree.
"""
from __future__ import annotations

from typing import Tuple

import torch


def ssd_chunk_ref(Cc: torch.Tensor, Bc: torch.Tensor, xdt: torch.Tensor,
                  dA_cs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cc/Bc (B,nc,Q,H,N) head-expanded, xdt (B,nc,Q,H,P), dA_cs (B,nc,H,Q)
    float32 -> (y_diag (B,nc,Q,H,P) in xdt's dtype, states (B,nc,H,P,N)
    float32)."""
    C = Cc.float().permute(0, 1, 3, 2, 4)                      # (B,nc,H,Q,N)
    Bm = Bc.float().permute(0, 1, 3, 2, 4)
    x = xdt.float().permute(0, 1, 3, 2, 4)                      # (B,nc,H,Q,P)
    dA = dA_cs.float()
    Q = dA.shape[-1]
    seg = dA[..., :, None] - dA[..., None, :]                   # (B,nc,H,Q,Q)
    lower = torch.ones((Q, Q), dtype=torch.bool, device=dA.device).tril()
    L = torch.where(lower, torch.exp(seg), 0.0)
    y = (C @ Bm.transpose(-1, -2) * L) @ x
    decay = torch.exp(dA[..., -1:] - dA)                        # (B,nc,H,Q)
    states = x.transpose(-1, -2) @ (Bm * decay[..., None])     # (B,nc,H,P,N)
    return y.permute(0, 1, 3, 2, 4).to(xdt.dtype), states
