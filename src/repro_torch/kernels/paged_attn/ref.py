"""Plain PyTorch version of the paged-attention kernel (csrc/paged_attn.cu).

It computes what the reference's Pallas kernel computes
(``repro/kernels/paged_attn/kernel.py::_kernel``), which is what the
reference dispatches on its accelerator: gather each slot's pages through
its page table as ``gather_pages`` does (an unassigned page reads as
``pos = -1``, k/v 0), score ``q . k`` in float32 divided by ``sqrt(D)``,
round the score through q's dtype when q is not float32, softcap, mask
(page assigned, ``pos >= 0``, ``pos <= qpos``, and ``qpos - pos < window``
when ``window > 0``), softmax in float32 with float32 ``p`` in the P.V
product, and give 0 for a row with no attendable key.

It does not follow the reference's lax fallback ``attend_masked``
(``repro/models/attention.py``), which in bfloat16 multiplies by
``1/sqrt(D)`` and casts ``p`` to q's dtype before P.V: the two agree only
in float32. The wrapper in ``ops.py`` uses this version for tensors on the
CPU, and the checks on the card hold the kernel against it.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def paged_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, pos_pool: torch.Tensor,
                        page_rows: torch.Tensor, qpos: torch.Tensor, *,
                        window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """q (B,T,Hq,D); k/v pool (P,ps,Hkv,D); pos pool (P,ps) absolute
    positions (-1 empty); page_rows (B,n) page ids (-1 unassigned); qpos
    (B,T) -> (B,T,Hq,D) in q's dtype, before the output projection."""
    B, T, Hq, D = q.shape
    ps, Hkv = k_pool.shape[1], k_pool.shape[2]
    G = Hq // Hkv
    n = page_rows.shape[1]
    assigned = page_rows >= 0                                   # (B,n)
    safe = page_rows.clamp(min=0).long()
    k = torch.where(assigned[:, :, None, None, None], k_pool[safe], 0)
    v = torch.where(assigned[:, :, None, None, None], v_pool[safe], 0)
    kp = torch.where(assigned[:, :, None], pos_pool[safe], -1)
    k = k.reshape(B, n * ps, Hkv, D).float()
    v = v.reshape(B, n * ps, Hkv, D).float()
    kp = kp.reshape(B, n * ps)

    qr = q.reshape(B, T, Hkv, G, D).float()
    s = torch.einsum("bthgd,bkhd->bhgtk", qr, k) / math.sqrt(D)
    if q.dtype != torch.float32:
        s = s.to(q.dtype).float()
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    kpb = kp[:, None, None, None, :]                            # (B,1,1,1,L)
    pq = qpos[:, None, None, :, None]                           # (B,1,1,T,1)
    mask = (kpb >= 0) & (kpb <= pq)
    if window:
        mask = mask & (pq - kpb < window)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1)                                           # (B,Hkv,G,T)
    acc = torch.einsum("bhgtk,bkhd->bhgtd", p, v)
    out = acc / l.clamp(min=1e-30)[..., None]
    out = torch.where(l[..., None] > 0, out, 0.0)               # nothing to attend
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, Hq, D).to(q.dtype)
