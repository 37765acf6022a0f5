"""Plain PyTorch version of the sliding-window attention kernel
(csrc/local_attn.cu).

It computes what the reference's Pallas kernel computes
(``repro/kernels/local_attn/kernel.py::_kernel``) for q (B,S,Hq,D) and
k/v (B,S,Hkv,D), query head h reading KV head h // (Hq/Hkv):

    s[i,j] = q_i . k_j / sqrt(D)              (float32, a division)
    s[i,j] = c * tanh(s[i,j] / c)            (with a softcap c > 0)
    key j attendable from query i iff 0 <= j < S, i - j < window and
             (causal: i - j >= 0;  non-causal: j - i < window)
    out_i  = sum_j exp(s_ij - m_i) v_j / max(sum_j exp(s_ij - m_i), 1e-30)

over the attendable keys, in float32, cast to q's dtype. The softcap is
the reference's model code's (``attention.local_attention(softcap_val=)``,
applied in float32 after the scale and before the mask); the Pallas
kernel has none. ``softcap=0`` leaves the function as it was without it,
to the bit. It walks the
queries in blocks and, for each, only the keys of its band, so memory
stays O(block * (window + block)).

The reference's model code (``attention.local_attention``) multiplies by
``1/sqrt(D)`` and rounds the scores and ``p`` through the activation
dtype; in bfloat16 the two differ by a few ulps, in float32 they agree to
rounding.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def local_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        window: int, causal: bool = True,
                        softcap: float = 0.0,
                        block_q: int = 512) -> torch.Tensor:
    """q (B,S,Hq,D), k/v (B,S,Hkv,D) -> (B,S,Hq,D) in q's dtype."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qf = q.float().reshape(B, S, Hkv, G, D)
    kf, vf = k.float(), v.float()
    pos = torch.arange(S, device=q.device)
    out = []
    for i0 in range(0, S, block_q):
        i1 = min(S, i0 + block_q)
        j0 = max(0, i0 - window + 1)
        j1 = i1 if causal else min(S, i1 + window - 1)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf[:, i0:i1],
                         kf[:, j0:j1]) / math.sqrt(D)
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        delta = pos[i0:i1, None] - pos[None, j0:j1]
        mask = delta < window
        mask = mask & (delta >= 0) if causal else mask & (-delta < window)
        s = torch.where(mask, s, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.where(mask, torch.exp(s - m), 0.0)
        l = p.sum(dim=-1)
        acc = torch.einsum("bhgqk,bkhd->bhgqd", p, vf[:, j0:j1])
        out.append(acc / l.clamp(min=1e-30)[..., None])
    o = torch.cat(out, dim=3)                                   # (B,Hkv,G,S,D)
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, D).to(q.dtype)
