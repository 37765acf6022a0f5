"""Attention: GQA projections, whole-prompt prefill attention, KV caches,
and attention over a paged KV pool.

The port of the dense and paged parts of ``repro/models/attention.py``.
Layouts are BSHD: q (B, S, Hq, D); k/v (B, S, Hkv, D).

* ``flash_attention`` — whole-prompt (prefill) attention of a global
  layer, an online softmax over KV blocks in plain torch ops, as the
  reference's is plain JAX;
* the whole-prompt attention of a local (sliding-window) layer goes
  through ``kernels/local_attn``, where the reference computes
  ``local_attention`` inline in plain JAX;
* ``paged_attend`` and the three paged paths (decode, multi-token verify,
  chunked prefill) — every attention over the page pool goes through
  ``kernels/paged_attn`` (the Hopper kernel on the card, its plain
  version on the CPU).

Two differences from the reference, both about state:

* the reference returns new caches; the port writes K/V and positions
  into the pools IN PLACE and returns the same cache objects;
* the reference sends an invalid write (an inactive slot, an unassigned
  page, a position past the page row) to the out-of-bounds page id P,
  where ``.at[].set(mode="drop")`` drops it. Torch has no drop mode, so
  the port's pools hold one page more than the ``num_pages`` asked for:
  page P is a sink that takes every invalid write. No page table names
  it, so nothing reads it. Filtering the writes instead would cost a
  device-to-host synchronisation on every scatter on the card.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.local_attn.ops import local_attention_fused
from repro_torch.kernels.paged_attn.ops import paged_attention_fused
from repro_torch.models.layers import NEG_INF, apply_rope


# ---------------------------------------------------------------------------
# Projections
# ---------------------------------------------------------------------------
def qkv_project(params, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor):
    """x (B,S,d), positions (B,S) -> q (B,S,Hq,D), k/v (B,S,Hkv,D) with
    rope applied."""
    B, S, d = x.shape

    def proj(w):
        w = params[w].to(x.dtype)
        return (x @ w.reshape(d, -1)).view(B, S, w.shape[1], w.shape[2])

    q, k, v = proj("wq"), proj("wk"), proj("wv")
    if cfg.qkv_bias:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    if cfg.rope:
        # rope over (B,S,H,D): positions broadcast over the head axis
        q = apply_rope(q, positions[:, :, None], cfg.rope_theta)
        k = apply_rope(k, positions[:, :, None], cfg.rope_theta)
    return q, k, v


def out_project(params, x: torch.Tensor) -> torch.Tensor:
    """(B,S,Hq,D) -> (B,S,d)."""
    B, S = x.shape[:2]
    wo = params["wo"].to(x.dtype)
    return x.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1])


# ---------------------------------------------------------------------------
# Flash attention (global): online softmax over KV blocks
# ---------------------------------------------------------------------------
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, softcap_val: float = 0.0,
                    block_k: int = 1024, block_q: int = 1024,
                    q_positions: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Online-softmax attention, O(block_q*block_k) live score memory.

    q (B,Sq,Hq,D), k/v (B,Sk,Hkv,D) -> (B,Sq,Hq,D). Query rows are
    independent, so tiles of ``block_q`` rows run one after another; each
    walks the KV tiles with the same arithmetic as the reference (scores
    in q's dtype, then float32 times ``1/sqrt(D)``; ``p`` in v's dtype in
    the P.V product)."""
    B, Sq, Hq, D = q.shape
    dev = q.device
    if q_positions is None:
        q_positions = torch.arange(Sq, dtype=torch.int32, device=dev).expand(B, Sq)
    if Sq > block_q:
        return torch.cat([
            flash_attention(q[:, i:i + block_q], k, v, causal=causal,
                            softcap_val=softcap_val, block_k=block_k,
                            block_q=block_q,
                            q_positions=q_positions[:, i:i + block_q])
            for i in range(0, Sq, block_q)], dim=1)
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qr = q.reshape(B, Sq, Hkv, G, D)
    k_positions = torch.arange(Sk, dtype=torch.int32, device=dev)
    m = torch.full((B, Hkv, G, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, G, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, G, Sq, D), dtype=torch.float32, device=dev)
    for start in range(0, Sk, block_k):
        kb = k[:, start:start + block_k]
        vb = v[:, start:start + block_k]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qr, kb).float() * scale
        if softcap_val:
            s = softcap_val * torch.tanh(s / softcap_val)
        if causal:
            kp = k_positions[start:start + block_k]
            mask = kp <= q_positions[:, None, None, :, None]
        else:
            mask = torch.ones_like(s, dtype=torch.bool)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(vb.dtype), vb).float()
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / l.clamp(min=1e-30)[..., None]                  # (B,Hkv,G,Sq,D)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D).to(q.dtype)


def attention_block(params, cfg: ModelConfig, x: torch.Tensor, *, kind: str,
                    local: Callable = local_attention_fused):
    """Whole-prompt attention layer for prefill: x (B,S,d) ->
    (out (B,S,d), (k, v)). A global layer runs ``flash_attention``; a
    local layer runs ``local``, the sliding-window kernel's wrapper
    (its plain version is passed only to check the kernel's run on the
    card), with ``window=cfg.window`` and ``softcap=cfg.attn_softcap``
    (gemma2's 50, applied to the float32 scores before the mask, as the
    reference's ``local_attention`` does). The training path
    (``blockq_attention``) comes with a later slice."""
    if kind not in ("global", "local"):
        raise ValueError(kind)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    q, k, v = qkv_project(params, cfg, x, positions)
    if kind == "local":
        o = local(q.contiguous(), k.contiguous(), v.contiguous(),
                  window=cfg.window, causal=cfg.causal,
                  softcap=float(cfg.attn_softcap))
    else:
        o = flash_attention(q, k, v, causal=cfg.causal,
                            softcap_val=cfg.attn_softcap)
    return out_project(params, o), (k, v)


# ---------------------------------------------------------------------------
# KV cache (contiguous ring): what a whole-prompt prefill produces
# ---------------------------------------------------------------------------
class KVCache(NamedTuple):
    k: torch.Tensor          # (B, L, Hkv, D)
    v: torch.Tensor          # (B, L, Hkv, D)
    pos: torch.Tensor        # (B, L) absolute position of each slot, -1 = empty


def init_kv_cache(batch: int, length: int, hkv: int, dh: int,
                  dtype=torch.bfloat16, device="cpu") -> KVCache:
    return KVCache(
        k=torch.zeros((batch, length, hkv, dh), dtype=dtype, device=device),
        v=torch.zeros((batch, length, hkv, dh), dtype=dtype, device=device),
        pos=torch.full((batch, length), -1, dtype=torch.int32, device=device),
    )


def cache_length(cfg: ModelConfig, kind: str, max_len: int) -> int:
    """Ring length: full context for global layers, window for local."""
    if kind == "local":
        return min(cfg.window, max_len)
    return max_len


def fill_cache_from_prefill(cache: KVCache, k: torch.Tensor,
                            v: torch.Tensor) -> KVCache:
    """Write a full prefill's K/V (B,S,Hkv,D) into a length-L ring cache,
    in place."""
    B, S = k.shape[0], k.shape[1]
    L = cache.k.shape[1]
    take = min(S, L)
    pos_t = torch.arange(S - take, S, dtype=torch.int32, device=k.device)
    slots = (pos_t % L).long()
    cache.k[:, slots] = k[:, S - take:].to(cache.k.dtype)
    cache.v[:, slots] = v[:, S - take:].to(cache.v.dtype)
    cache.pos[:, slots] = pos_t[None, :].expand(B, take)
    return cache


# ---------------------------------------------------------------------------
# Paged KV cache: a pool of fixed-size pages shared by all request slots.
#
# Physical layout is (num_pages + 1, page_size, Hkv, D); a slot owns an
# ordered page row (pages_per_slot,) of physical page ids (-1 = unassigned)
# mapping logical token index i -> pool[row[i // page_size], i % page_size].
# Page num_pages is the write sink (see the module docstring).
# ---------------------------------------------------------------------------
class PagedKVCache(NamedTuple):
    k: torch.Tensor          # (P + 1, page_size, Hkv, D)
    v: torch.Tensor          # (P + 1, page_size, Hkv, D)
    pos: torch.Tensor        # (P + 1, page_size) absolute position, -1 = empty

    @property
    def num_pages(self) -> int:
        """Pages a page table may name; the page at this index is the sink."""
        return self.k.shape[0] - 1


def init_paged_kv_cache(num_pages: int, page_size: int, hkv: int, dh: int,
                        dtype=torch.bfloat16, device="cpu") -> PagedKVCache:
    shape = (num_pages + 1, page_size)
    return PagedKVCache(
        k=torch.zeros(shape + (hkv, dh), dtype=dtype, device=device),
        v=torch.zeros(shape + (hkv, dh), dtype=dtype, device=device),
        pos=torch.full(shape, -1, dtype=torch.int32, device=device),
    )


def _page_coords(page_rows: torch.Tensor, logical: torch.Tensor, ps: int,
                 P: int, extra_ok: Optional[torch.Tensor] = None):
    """Map logical token indices to (physical page, offset), with invalid
    indices sent to the sink page ``P``. page_rows (..., n) and logical
    (...,) share leading dims."""
    n = page_rows.shape[-1]
    lp = torch.div(logical, ps, rounding_mode="floor")
    ok = (logical >= 0) & (lp < n)
    if extra_ok is not None:
        ok = ok & extra_ok
    phys = torch.gather(page_rows, -1,
                        lp.clamp(0, n - 1)[..., None].long())[..., 0]
    phys = torch.where(ok & (phys >= 0), phys, P)
    return phys.long(), (logical % ps).long(), ok


def _write(cache: PagedKVCache, phys, off, k_new, v_new, pos) -> None:
    """Scatter new entries into the pools in place (the sink takes the
    invalid ones)."""
    cache.k[phys, off] = k_new.to(cache.k.dtype)
    cache.v[phys, off] = v_new.to(cache.v.dtype)
    cache.pos[phys, off] = pos.to(torch.int32)


def paged_attend(params, cfg: ModelConfig, q: torch.Tensor,
                 cache: PagedKVCache, page_rows: torch.Tensor,
                 qpos: torch.Tensor, *, window: Optional[int] = None,
                 attn: Callable = paged_attention_fused) -> torch.Tensor:
    """Attend q (B,T,Hq,D) against the page pool through slot page tables
    page_rows (B,n) and project out. ``attn`` is the paged-attention
    kernel's wrapper; its plain version is passed only to check the
    kernel's run against it on the card."""
    o = attn(q.contiguous(), cache.k, cache.v, cache.pos,
             page_rows.contiguous(), qpos.contiguous(),
             window=int(window) if window else 0,
             softcap=float(cfg.attn_softcap) if cfg.attn_softcap else 0.0)
    return out_project(params, o)


def paged_fill_from_prefill(pool: PagedKVCache, ring: KVCache,
                            page_row: torch.Tensor) -> PagedKVCache:
    """Write a single-request contiguous prefill cache ``ring`` (batch 1,
    ring layout with absolute positions) into the slot's pages of ``pool``,
    in place."""
    pos = ring.pos[0]                                           # (L,) absolute, -1 empty
    rows = page_row.expand(pos.shape[0], page_row.shape[-1])
    phys, off, _ = _page_coords(rows, pos, pool.k.shape[1], pool.num_pages)
    _write(pool, phys, off, ring.k[0], ring.v[0], pos)
    return pool


def _positions(position, B: int, device) -> torch.Tensor:
    """A scalar or (B,) position as a (B,) int32 tensor."""
    pos = torch.as_tensor(position, dtype=torch.int32, device=device)
    return pos.reshape(-1).expand(B)


def paged_decode_attention(params, cfg: ModelConfig, x: torch.Tensor,
                           cache: PagedKVCache, page_rows: torch.Tensor,
                           position, *, window: Optional[int] = None,
                           active: Optional[torch.Tensor] = None,
                           attn: Callable = paged_attention_fused):
    """One decode step against the page pool. x (B,1,d); page_rows (B,n)
    per-slot page tables; position (B,) per-row write index; ``active``
    (B,) bool — inactive rows (free slots, or slots mid-chunked-prefill)
    write into the sink, so they can never clobber a live page.

    Returns (out (B,1,d), cache updated in place)."""
    B = x.shape[0]
    pos = _positions(position, B, x.device)
    q, k_new, v_new = qkv_project(params, cfg, x, pos[:, None])
    phys, off, _ = _page_coords(page_rows, pos, cache.k.shape[1],
                                cache.num_pages, extra_ok=active)
    _write(cache, phys, off, k_new[:, 0], v_new[:, 0], pos)
    out = paged_attend(params, cfg, q, cache, page_rows, pos[:, None],
                       window=window, attn=attn)
    return out, cache


def paged_multitok_attention(params, cfg: ModelConfig, x: torch.Tensor,
                             cache: PagedKVCache, page_rows: torch.Tensor,
                             position, *, window: Optional[int] = None,
                             active: Optional[torch.Tensor] = None,
                             attn: Callable = paged_attention_fused):
    """Multi-token paged attention for ALL slots at once: x (B,T,d) holds T
    consecutive tokens per slot, row b starting at absolute
    ``position[b]``. Every token's K/V is scattered into its slot's pages
    (inactive rows' writes go to the sink), then each query attends to
    its slot's whole cache, causality within the run coming from the
    position mask: a query at position p never sees entries with pos > p,
    so entries written by later-rejected draft tokens stay invisible and
    are overwritten before the real sequence reaches them.

    The chunked-prefill path (B=1) and the draft-verification path.
    Returns (out (B,T,d), cache updated in place)."""
    B, T, _ = x.shape
    pos = _positions(position, B, x.device)
    qpos = pos[:, None] + torch.arange(T, dtype=torch.int32,
                                       device=x.device)[None, :]  # (B,T)
    q, k_new, v_new = qkv_project(params, cfg, x, qpos)
    rows = page_rows[:, None, :].expand(B, T, page_rows.shape[-1])
    extra = None if active is None else active[:, None]
    phys, off, _ = _page_coords(rows, qpos, cache.k.shape[1],
                                cache.num_pages, extra_ok=extra)
    _write(cache, phys, off, k_new, v_new, qpos)
    out = paged_attend(params, cfg, q, cache, page_rows, qpos,
                       window=window, attn=attn)
    return out, cache


def paged_prefill_attention(params, cfg: ModelConfig, x: torch.Tensor,
                            cache: PagedKVCache, page_row: torch.Tensor,
                            pos_start, *, window: Optional[int] = None,
                            attn: Callable = paged_attention_fused):
    """Chunked-prefill attention for ONE request slot: x (1,C,d) is one
    prompt chunk starting at absolute position ``pos_start``; a batch-1
    view of :func:`paged_multitok_attention`."""
    return paged_multitok_attention(params, cfg, x, cache, page_row[None],
                                    pos_start, window=window, attn=attn)
