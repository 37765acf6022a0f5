"""Attention: GQA projections, whole-prompt prefill attention, KV caches,
and attention over a paged KV pool.

The port of the dense and paged parts of ``repro/models/attention.py``.
Layouts are BSHD: q (B, S, Hq, D); k/v (B, S, Hkv, D).

* ``flash_attention`` — whole-prompt (prefill) attention of a global
  layer, an online softmax over KV blocks in plain torch ops, as the
  reference's is plain JAX;
* ``blockq_attention`` — the training attention of a global layer: each
  Q block takes a full softmax over all of K, in plain torch ops, as the
  reference's is plain JAX, each block checkpointed so that its scores are
  recomputed in the backward;
* the whole-sequence attention of a local (sliding-window) layer, in
  prefill and in training, goes through ``kernels/local_attn``, where the
  reference computes ``local_attention`` inline in plain JAX;
* ``paged_attend`` and the three paged paths (decode, multi-token verify,
  chunked prefill) — every attention over the page pool goes through
  ``kernels/paged_attn`` (the Hopper kernel on the card, its plain
  version on the CPU);
* the contiguous ring (``KVCache``, the reference's parity baseline):
  ``decode_attention`` writes one token a row at ``position % L`` and
  attends through ``attend_cached``/``attend_masked``, in plain torch ops
  as the reference computes them in plain JAX (no Pallas kernel replaces
  them).

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

On a mesh (DTensor params and caches, ``serve/engine.py`` with ``mesh=``)
the rules put a pool's pages on the batch axes ("pages") and its offsets
or KV heads on "model" ("cache_seq" / "kv_heads"), a ring's slots on the
batch axes. Cache writes never go through DTensor's ``index_put``: each
rank writes, in its local block, the entries it holds (``_write_local``,
``_write_ring``). Each shard of a pool's page axis keeps its OWN sink
after its pages: a pool of P pages on ``n`` shards is stored as ``n``
blocks of ``P/n + 1`` pages (global page ``g`` at storage row
``g + g // (P/n)``, ``storage_ids``), so that the split divides and each
rank drops the writes of pages it does not hold into its sink. With one
shard that is the one-device layout. Reads go through
``distributed/kernels.py`` on local blocks.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import kernels as dk
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import constrain
from repro_torch.kernels.local_attn.ops import local_attention_fused
from repro_torch.kernels.paged_attn.ops import paged_attention_fused
from repro_torch.models.layers import (
    NEG_INF, apply_norm, apply_rope, norm_specs,
)


def _shards(t) -> int:
    """Blocks of ``t``'s dim 0 on a mesh (1 for a plain tensor)."""
    if not shd.is_distributed(t):
        return 1
    return t.shape[0] // shd.shard_range(t, 0)[1]


def param_specs(cfg: ModelConfig):
    """Logical axes of each leaf, the reference's ``attn_params`` axes."""
    p = {"wq": ("embed", "heads", "head_dim"),
         "wk": ("embed", "kv_heads", "head_dim"),
         "wv": ("embed", "kv_heads", "head_dim"),
         "wo": ("heads", "head_dim", "embed")}
    if cfg.qkv_bias:
        p.update(bq=("heads", "head_dim"), bk=("kv_heads", "head_dim"),
                 bv=("kv_heads", "head_dim"))
    if cfg.qk_norm:
        p.update(q_norm=norm_specs("rmsnorm"), k_norm=norm_specs("rmsnorm"))
    return p


# ---------------------------------------------------------------------------
# Projections
# ---------------------------------------------------------------------------
def qkv_project(params, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor):
    """x (B,S,d), positions (B,S) -> q (B,S,Hq,D), k/v (B,S,Hkv,D) with
    the biases, QK norm and rope applied."""
    B, S, d = x.shape

    def proj(w):
        w = params[w].to(x.dtype)
        return (x @ w.reshape(d, -1)).view(B, S, w.shape[1], w.shape[2])

    q, k, v = proj("wq"), proj("wk"), proj("wv")
    if cfg.qkv_bias:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    if cfg.qk_norm:
        # qwen3: RMSNorm over each head's D channels, before rope
        q = apply_norm(params["q_norm"], "rmsnorm", q)
        k = apply_norm(params["k_norm"], "rmsnorm", k)
    if cfg.rope:
        # rope over (B,S,H,D): positions broadcast over the head axis
        q = apply_rope(q, positions[:, :, None], cfg.rope_theta)
        k = apply_rope(k, positions[:, :, None], cfg.rope_theta)
    q = constrain(q, ("batch", "seq", "heads", "head_dim"))
    k = constrain(k, ("batch", "seq", "kv_heads", "head_dim"))
    v = constrain(v, ("batch", "seq", "kv_heads", "head_dim"))
    return q, k, v


def out_project(params, x: torch.Tensor) -> torch.Tensor:
    """(B,S,Hq,D) -> (B,S,d)."""
    B, S = x.shape[:2]
    wo = params["wo"].to(x.dtype)
    out = x.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1])
    return constrain(out, ("batch", "seq", "embed"))


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


# ---------------------------------------------------------------------------
# Block-Q attention (global) for training
# ---------------------------------------------------------------------------
def _blockq_scores(qb: torch.Tensor, q_pos: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, causal: bool, softcap_val: float,
                   scale: float) -> torch.Tensor:
    """One Q block (B,bq,Hkv,G,D) against all of K: (B,Hkv,G,bq,D)."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", qb, k).float() * scale
    if softcap_val:
        s = softcap_val * torch.tanh(s / softcap_val)
    if causal:
        k_pos = torch.arange(k.shape[1], device=k.device)
        s = torch.where(k_pos[None, :] <= q_pos[:, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype), v)


def blockq_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool = True, softcap_val: float = 0.0,
                     block_q: int = 512) -> torch.Tensor:
    """Training attention of a global layer. q (B,Sq,Hq,D), k/v
    (B,Sk,Hkv,D) -> (B,Sq,Hq,D). Each block of ``block_q`` queries takes
    a full softmax over all of K (scores in q's dtype, then float32 times
    ``1/sqrt(D)``, the softcap, the causal mask; ``p`` in v's dtype in the
    P.V product), each block checkpointed, so that the backward
    recomputes one block's scores at a time: the reference's
    ``jax.checkpoint`` per block."""
    from torch.utils.checkpoint import checkpoint
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    block_q = min(block_q, Sq)
    qr = q.reshape(B, Sq, Hkv, G, D)
    pos = torch.arange(Sq, device=q.device)
    out = torch.cat([checkpoint(_blockq_scores, qr[:, i:i + block_q],
                                pos[i:i + block_q], k, v, causal, softcap_val,
                                scale, use_reentrant=False,
                                preserve_rng_state=False)
                     for i in range(0, Sq, block_q)], dim=3)    # (B,Hkv,G,Sq,D)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D).to(q.dtype)


def attention_block(params, cfg: ModelConfig, x: torch.Tensor, *, kind: str,
                    local: Callable = local_attention_fused,
                    return_kv: bool = False):
    """Whole-sequence attention layer: x (B,S,d) -> (out (B,S,d), (k, v))
    with ``return_kv`` (prefill), else out alone (training). A global
    layer runs ``flash_attention`` for prefill and ``blockq_attention``
    for training, as the reference's does; a local layer runs ``local``
    in both, the sliding-window kernel's wrapper (its plain version is
    passed only to check the kernel's run on the card), with
    ``window=cfg.window`` and ``softcap=cfg.attn_softcap`` (gemma2's 50,
    applied to the float32 scores before the mask, as the reference's
    ``local_attention`` does). On a mesh each runs on local blocks of
    batch and heads (``distributed/kernels.py::local_attention``)."""
    if kind not in ("global", "local"):
        raise ValueError(kind)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    q, k, v = qkv_project(params, cfg, x, positions)
    if kind == "local":
        kw = dict(window=cfg.window, causal=cfg.causal,
                  softcap=float(cfg.attn_softcap))
        o = (dk.local_attention(local, q, k, v, **kw)
             if shd.is_distributed(q) else
             local(q.contiguous(), k.contiguous(), v.contiguous(), **kw))
    else:
        # a global layer: flash attention for prefill, block-Q for
        # training; on a mesh on local blocks of batch and heads
        fn = flash_attention if return_kv else blockq_attention
        kw = dict(causal=cfg.causal, softcap_val=cfg.attn_softcap)
        o = (dk.local_attention(lambda a, b, c: fn(a, b, c, **kw), q, k, v)
             if shd.is_distributed(q) else fn(q, k, v, **kw))
    out = out_project(params, o)
    return (out, (k, v)) if return_kv else out


# ---------------------------------------------------------------------------
# KV cache (contiguous ring): what a whole-prompt prefill produces
# ---------------------------------------------------------------------------
class KVCache(NamedTuple):
    k: torch.Tensor          # (B, L, Hkv, D)
    v: torch.Tensor          # (B, L, Hkv, D)
    pos: torch.Tensor        # (B, L) absolute position of each slot, -1 = empty


def kv_cache_axes() -> KVCache:
    """Logical axes of each leaf of a ring."""
    return KVCache(
        k=("batch", "cache_seq", "kv_heads", "head_dim"),
        v=("batch", "cache_seq", "kv_heads", "head_dim"),
        pos=("batch", "cache_seq"),
    )


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
    in place. On a mesh the ring is filled on each rank's block of rows
    and heads and placed as ``k`` (``_fill_local``; no collective)."""
    if shd.is_distributed(k):
        return _fill_local(cache, k, v)
    B, S = k.shape[0], k.shape[1]
    L = cache.k.shape[1]
    take = min(S, L)
    pos_t = torch.arange(S - take, S, dtype=torch.int32, device=k.device)
    slots = (pos_t % L).long()
    cache.k[:, slots] = k[:, S - take:].to(cache.k.dtype)
    cache.v[:, slots] = v[:, S - take:].to(cache.v.dtype)
    cache.pos[:, slots] = pos_t[None, :].expand(B, take)
    return cache


def _fill_local(cache: KVCache, k, v) -> KVCache:
    """``fill_cache_from_prefill`` of DTensor ``k``/``v`` (B,S,Hkv,D)
    split on rows and heads, never on S: each rank fills the ring of its
    block, and the ring's leaves are DTensors placed as ``k`` (``pos`` as
    its rows)."""
    kl, vl = k.to_local(), v.to_local()
    L = cache.k.shape[1]
    ring = fill_cache_from_prefill(init_kv_cache(
        kl.shape[0], L, kl.shape[2], kl.shape[3], dtype=cache.k.dtype,
        device=kl.device), kl, vl)
    mesh = k.device_mesh
    rows = tuple(p if p == shd.Shard(0) else shd.Replicate()
                 for p in k.placements)

    def wrap(t, pl, shape):
        stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
        return shd.DTensor.from_local(t, mesh, pl, run_check=False,
                                      shape=torch.Size(shape), stride=stride)
    full = (k.shape[0], L) + tuple(k.shape[2:])
    return KVCache(wrap(ring.k, k.placements, full),
                   wrap(ring.v, v.placements, full),
                   wrap(ring.pos, rows, full[:2]))


def attend_masked(cfg: ModelConfig, q: torch.Tensor, k_all: torch.Tensor,
                  v_all: torch.Tensor, kp: torch.Tensor, qpos: torch.Tensor, *,
                  window: Optional[int] = None) -> torch.Tensor:
    """Projection-free core of :func:`attend_cached`: q (B,Sq,Hq,D)
    against cache entries k/v (B,L,Hkv,D) whose absolute positions are kp
    (B,L), -1 = empty -> (B,Sq,Hq,D). The reference's "lax counterpart" of
    the paged kernel, in plain torch ops: scores in q's dtype, then float32
    times ``1/sqrt(D)``, the softcap, the position mask (causal, window),
    a softmax, ``p`` in q's dtype in the P.V product."""
    B, Sq, Hq, dh = q.shape
    Hkv = k_all.shape[2]
    G = Hq // Hkv
    qr = q.reshape(B, Sq, Hkv, G, dh)
    scale = 1.0 / math.sqrt(dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qr,
                     k_all.to(q.dtype)).float() * scale
    if cfg.attn_softcap:
        s = cfg.attn_softcap * torch.tanh(s / cfg.attn_softcap)
    kpb = kp[:, None, None, None, :]                            # (B,1,1,1,L)
    pq = qpos[:, None, None, :, None]                           # (B,1,1,Sq,1)
    mask = (kpb >= 0) & (kpb <= pq)
    if window is not None:
        mask = mask & (pq - kpb < window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p.to(q.dtype), v_all.to(q.dtype))
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, dh)


def attend_cached(params, cfg: ModelConfig, q: torch.Tensor,
                  k_all: torch.Tensor, v_all: torch.Tensor, kp: torch.Tensor,
                  qpos: torch.Tensor, *,
                  window: Optional[int] = None) -> torch.Tensor:
    """Masked attention of q (B,Sq,Hq,D) against cache entries k/v
    (B,L,Hkv,D) at absolute positions kp (B,L), -1 = empty, and the output
    projection; causality and the window come from the positions alone.
    On a mesh it runs on local blocks of batch and heads, the ring's
    sequence axis gathered."""
    if shd.is_distributed(q):
        o = dk.attend_masked(
            lambda a, b, c, d, e: attend_masked(cfg, a, b, c, d, e,
                                                window=window),
            q, k_all, v_all, kp, qpos)
    else:
        o = attend_masked(cfg, q, k_all, v_all, kp, qpos, window=window)
    return out_project(params, o)


def _write_ring(cache: KVCache, row_slot: torch.Tensor, k_new, v_new,
                pos: torch.Tensor) -> None:
    """Write one entry a row, row b at ring index ``row_slot[b]``, in
    place. On a mesh each rank writes its rows' entries that fall in its
    block of the ring (an entry elsewhere writes back what its clamped
    index holds: each row has one entry, so no write is lost)."""
    if not shd.is_distributed(cache.k):
        bidx = torch.arange(row_slot.shape[0], device=row_slot.device)
        cache.k[bidx, row_slot] = k_new.to(cache.k.dtype)
        cache.v[bidx, row_slot] = v_new.to(cache.v.dtype)
        cache.pos[bidx, row_slot] = pos.to(torch.int32)
        return
    b0, bn = shd.shard_range(cache.k, 0)
    l0, ln = shd.shard_range(cache.k, 1)
    ls = row_slot[b0:b0 + bn] - l0
    ok = (ls >= 0) & (ls < ln)
    li = torch.where(ok, ls, 0).long()
    bi = torch.arange(bn, device=li.device)
    for leaf, val in ((cache.k, k_new), (cache.v, v_new), (cache.pos, pos)):
        loc = leaf.to_local()
        new = shd.full(val)[b0:b0 + bn].to(loc.dtype)     # (bn, [Hkv, D])
        if new.dim() > 1:
            h0, hn = shd.shard_range(leaf, 2)
            new = new.narrow(1, h0, hn)
        old = loc[bi, li]
        m = ok.reshape((-1,) + (1,) * (new.dim() - 1))
        loc[bi, li] = torch.where(m, new, old)


def decode_attention(params, cfg: ModelConfig, x: torch.Tensor,
                     cache: KVCache, position, *,
                     window: Optional[int] = None):
    """One decode step against a contiguous ring. x (B,1,d); position a
    scalar (every row at the same index) or a (B,) vector of per-row
    indices (the engine's slots, each at its own counter). Row b's K/V
    go into ring index ``position[b] % L``, in place; the attention reads
    the whole ring through its positions. Returns (out (B,1,d), cache)."""
    B = x.shape[0]
    pos = _positions(position, B, x.device)
    q, k_new, v_new = qkv_project(params, cfg, x, pos[:, None])
    L = cache.k.shape[1]
    _write_ring(cache, pos.long() % L, k_new[:, 0], v_new[:, 0], pos)
    out = attend_cached(params, cfg, q, cache.k, cache.v, cache.pos,
                        pos[:, None], window=window)
    return out, cache


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
        """Pages a page table may name (the global page id at this index is
        the invalid one, which every shard's sink takes)."""
        return self.k.shape[0] - _shards(self.k)

    @property
    def per_shard(self) -> int:
        """Pages of one shard of the page axis (its sink not counted)."""
        return self.num_pages // _shards(self.k)


def storage_ids(pool: PagedKVCache, pages) -> list:
    """Storage rows of the global page ids ``pages`` (host ints >= 0):
    page ``g`` of a pool split into shards of ``n`` pages, each followed
    by its sink, sits at row ``g + g // n``."""
    n = pool.per_shard
    return [int(g) + int(g) // n for g in pages]


def paged_kv_cache_axes() -> PagedKVCache:
    """Logical axes of each leaf of a pool: the page axis on the batch
    axes; the within-page offset axis takes the "cache_seq" rule, so both
    ``cache_needs_seq_shard`` branches carry over from the ring."""
    return PagedKVCache(
        k=("pages", "cache_seq", "kv_heads", "head_dim"),
        v=("pages", "cache_seq", "kv_heads", "head_dim"),
        pos=("pages", "cache_seq"),
    )


def init_paged_kv_cache(num_pages: int, page_size: int, hkv: int, dh: int,
                        dtype=torch.bfloat16, device="cpu",
                        shards: int = 1) -> PagedKVCache:
    """An empty pool of ``num_pages`` pages in ``shards`` blocks, each
    block's pages followed by its sink (one sink, the last page, for one
    block)."""
    if num_pages % shards:
        raise ValueError(f"{num_pages} pages do not split into {shards}")
    shape = (num_pages + shards, page_size)
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
    if shd.is_distributed(cache.k):
        return _write_local(cache, phys, off, k_new, v_new, pos)
    cache.k[phys, off] = k_new.to(cache.k.dtype)
    cache.v[phys, off] = v_new.to(cache.v.dtype)
    cache.pos[phys, off] = pos.to(torch.int32)


def _write_local(cache: PagedKVCache, phys, off, k_new, v_new, pos) -> None:
    """``_write`` on a mesh, on local blocks: the new entries are gathered
    whole (N entries of (Hkv, D) a leaf, the collective of a write), and
    each rank writes those whose page and offset it holds, the part of
    their heads in its block; the rest go to its own sink."""
    n = cache.per_shard
    p0, _ = shd.shard_range(cache.k, 0)
    o0, on = shd.shard_range(cache.k, 1)
    local = phys - (p0 // (n + 1)) * n
    ok = (phys < cache.num_pages) & (local >= 0) & (local < n) \
        & (off >= o0) & (off < o0 + on)
    lp = torch.where(ok, local, n)
    lo = torch.where(ok, off - o0, 0)
    for leaf, val in ((cache.k, k_new), (cache.v, v_new), (cache.pos, pos)):
        loc = leaf.to_local()
        loc[lp, lo] = shd.block_of(shd.full(val).to(loc.dtype), leaf, lead=2)


def paged_attend(params, cfg: ModelConfig, q: torch.Tensor,
                 cache: PagedKVCache, page_rows: torch.Tensor,
                 qpos: torch.Tensor, *, window: Optional[int] = None,
                 attn: Callable = paged_attention_fused) -> torch.Tensor:
    """Attend q (B,T,Hq,D) against the page pool through slot page tables
    page_rows (B,n) and project out. ``attn`` is the paged-attention
    kernel's wrapper; its plain version is passed only to check the
    kernel's run against it on the card."""
    kw = dict(window=int(window) if window else 0,
              softcap=float(cfg.attn_softcap) if cfg.attn_softcap else 0.0)
    if shd.is_distributed(q):
        o = dk.paged_attention(attn, q, cache, page_rows, qpos, **kw)
    else:
        o = attn(q.contiguous(), cache.k, cache.v, cache.pos,
                 page_rows.contiguous(), qpos.contiguous(), **kw)
    return out_project(params, o)


def paged_fill_from_prefill(pool: PagedKVCache, ring: KVCache,
                            page_row: torch.Tensor) -> PagedKVCache:
    """Write a single-request contiguous prefill cache ``ring`` (batch 1,
    ring layout with absolute positions) into the slot's pages of ``pool``,
    in place (on a mesh the ring, placed as the prefill's K, is gathered
    whole first)."""
    ring = KVCache(*(shd.full(t) for t in ring))
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
