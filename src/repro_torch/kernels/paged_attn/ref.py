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


def _masked_scores(q, k_pool, v_pool, pos_pool, page_rows, qpos, window,
                   softcap):
    """Gather the pages of ``page_rows`` (B,c) and score q against them:
    (masked scores (B,Hkv,G,T,c*ps), mask, float32 v (B,c*ps,Hkv,D))."""
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
    return torch.where(mask, s, NEG_INF), mask, v


def paged_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, pos_pool: torch.Tensor,
                        page_rows: torch.Tensor, qpos: torch.Tensor, *,
                        window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """q (B,T,Hq,D); k/v pool (P,ps,Hkv,D); pos pool (P,ps) absolute
    positions (-1 empty); page_rows (B,n) page ids (-1 unassigned); qpos
    (B,T) -> (B,T,Hq,D) in q's dtype, before the output projection."""
    B, T, Hq, D = q.shape
    s, mask, v = _masked_scores(q, k_pool, v_pool, pos_pool, page_rows, qpos,
                                window, softcap)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1)                                           # (B,Hkv,G,T)
    acc = torch.einsum("bhgtk,bkhd->bhgtd", p, v)
    out = acc / l.clamp(min=1e-30)[..., None]
    out = torch.where(l[..., None] > 0, out, 0.0)               # nothing to attend
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, Hq, D).to(q.dtype)


def paged_attention_split_ref(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor, pos_pool: torch.Tensor,
                              page_rows: torch.Tensor, qpos: torch.Tensor, *,
                              pages_per_split: int, window: int = 0,
                              softcap: float = 0.0) -> torch.Tensor:
    """The kernel's split-K algorithm, plainly: each split of
    ``pages_per_split`` page-table columns forms its partial softmax (m, l,
    acc) with the same masks, and the partials merge as the merge kernel
    does: m* = max m_s, out = sum acc_s e^(m_s - m*) / max(sum l_s
    e^(m_s - m*), 1e-30), and 0 where sum l_s = 0. Equal to
    ``paged_attention_ref`` up to float32 rounding."""
    B, T, Hq, D = q.shape
    n = page_rows.shape[1]
    parts = []
    for c0 in range(0, n, pages_per_split):
        s, mask, v = _masked_scores(q, k_pool, v_pool, pos_pool,
                                    page_rows[:, c0:c0 + pages_per_split],
                                    qpos, window, softcap)
        m = s.amax(dim=-1)                                      # -1e30: none
        p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
        parts.append((m, p.sum(dim=-1), torch.einsum("bhgtk,bkhd->bhgtd", p, v)))
    m_all = torch.stack([m for m, _, _ in parts])               # (S,B,Hkv,G,T)
    e = torch.exp(m_all - m_all.amax(dim=0))
    den = sum(l * e_s for (_, l, _), e_s in zip(parts, e))
    num = sum(acc * e_s[..., None] for (_, _, acc), e_s in zip(parts, e))
    out = num / den.clamp(min=1e-30)[..., None]
    out = torch.where(den[..., None] > 0, out, 0.0)             # nothing to attend
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, Hq, D).to(q.dtype)
