"""The LM kernels on a mesh: each wrapper called on local blocks through
``local_map`` (``sharding.local_kernel``), with placements that keep its
work local.

* the causal conv1d is depthwise: a block of the batch and of the
  channels needs only its channels' taps and bias, so the rules' split of
  the channels (``inner`` on "model") is kept, and the weights follow it;
* the chunked SSD scan around the SSD-chunk kernel is per head: batch
  and heads stay split, each rank takes the ``B``/``C`` groups of its
  heads, and ``A``, ``D`` follow the heads; the SSM's recurrent form
  (decode, chunks, verify) likewise, its state split as its rules say;
* local attention is per head too: batch and query heads stay split.
  Where the KV heads are split alike, each rank's query groups meet their
  own KV heads. Where the KV heads are whole (``kv_heads`` does not divide
  the model axis) and each rank's query heads fall in one KV group, the
  rank slices that KV head; otherwise the query heads are gathered
  (``_head_plan``). A global layer's prefill attention runs so too;
* paged attention (serving) takes the same head plan against the page
  pool, whose page axis is gathered whole (a slot's pages may be on any
  rank: the page table holds global ids, mapped here to the storage rows
  of a pool whose shards each keep a sink, ``models/attention.py``) and
  whose within-page offsets are gathered where the ``cache_seq`` rule
  splits them; the page table and the query positions follow the
  queries' batch split;
* the contiguous ring's masked attention (``attend_masked``) likewise,
  the ring's sequence axis gathered where ``cache_seq`` splits it.

Any other split (a sequence split) is gathered before the call. A weight
that is whole on a mesh dim splitting the batch gets a Partial gradient
there, which the engine reduces.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from torch.distributed.tensor import Partial, Replicate, Shard

from repro_torch.distributed.sharding import (
    distribute, local_kernel, mesh_shape, weight_grad_placements,
)


def _keep(placements, dims):
    """``placements`` with every Shard not on ``dims`` made Replicate
    (and Partial reduced)."""
    return tuple(p if isinstance(p, Shard) and p.dim in dims else Replicate()
                 for p in placements)


def _follow(act, act_dim: int, own_dim: Optional[int]):
    """A weight's placements: split on ``own_dim`` where the activation is
    split on ``act_dim``, whole elsewhere."""
    return tuple(Shard(own_dim) if own_dim is not None
                 and isinstance(p, Shard) and p.dim == act_dim
                 else Replicate() for p in act)


def conv1d(conv: Callable, x, w, b, *, activation: str, tail=None):
    """``conv(x (B,S,C), w (K,C), b (C,), activation, tail)`` on local
    blocks of batch and channels -> (y, new tail) placed as ``x``."""
    at = _keep(x.placements, (0, 2))
    wt, bt = _follow(at, 2, 1), _follow(at, 2, 0)
    args = [x, w, b] + ([tail] if tail is not None else [])
    targets = [at, wt, bt] + ([at] if tail is not None else [])
    grads = [at, weight_grad_placements(wt, at),
             weight_grad_placements(bt, at)] + ([at] if tail is not None
                                                else [])

    def body(xl, wl, bl, *tl):
        return conv(xl.contiguous(), wl.contiguous(), bl.contiguous(),
                    activation=activation,
                    tail=tl[0].contiguous() if tl else None)
    return local_kernel(body, args, targets, [at, at], grads=grads)


def ssd_chunked(scan: Callable, xh, dt, A, Bm, Cm, D):
    """``scan(xh (B,S,H,P), dt (B,S,H), A (H,), Bm/Cm (B,S,G,N), D (H,))``
    (``models.ssm.ssd_chunked``, which calls the SSD-chunk kernel) on local
    blocks of batch and heads -> (y placed as ``xh``, the final state
    (B,H,P,N) split alike). ``B``/``C`` are whole over "model"; each rank
    takes the groups of its heads, which must be whole groups or lie in
    one group."""
    mesh = xh.device_mesh
    names = mesh_shape(mesh).axis_names
    at = _keep(xh.placements, (0, 2))
    ht = _follow(at, 2, 0)                        # A and D follow the heads
    bt = tuple(p if p == Shard(0) else Replicate() for p in at)
    bg = tuple(Partial() if p == Shard(2) else b for p, b in zip(at, bt))
    H, G = xh.shape[2], Bm.shape[2]
    rep = H // G
    split = [i for i, p in enumerate(at) if p == Shard(2)]
    Hl = H // (mesh.size(split[0]) if split else 1)
    h0 = mesh.get_local_rank(names[split[0]]) * Hl if split else 0
    if not (Hl % rep == 0 or rep % Hl == 0):
        raise ValueError(f"{Hl} heads a rank split the {G} groups of "
                         f"{rep} heads unevenly")
    g0, g1 = h0 // rep, (h0 + Hl - 1) // rep + 1

    def body(xl, dtl, Al, Bl, Cl, Dl):
        return scan(xl, dtl, Al, Bl[:, :, g0:g1], Cl[:, :, g0:g1], Dl)
    grads = [at, at, weight_grad_placements(ht, at), bg, bg,
             weight_grad_placements(ht, at)]
    st = tuple(Shard(1) if p == Shard(2) else p for p in at)
    return local_kernel(body, [xh, dt, A, Bm, Cm, D],
                        [at, at, ht, bt, bt, ht], [at, st], grads=grads)


def ssm_recurrence(fn: Callable, h, dA, xdt, Bh, Ch):
    """``fn(h (B,H,P,N), dA (B,T,H), xdt (B,T,H,P), Bh/Ch (B,T,H,N))``,
    the SSM's token-by-token state update and read-out
    (``models.ssm._recurrence``), on local blocks of batch and heads ->
    (y placed as ``xdt``, the last state placed as ``h``, the snapshots
    (T,B,H,P,N) split alike). Heads that the model axis does not divide
    are whole on every rank, as the state's rules place them."""
    ht = _keep(h.placements, (0, 1))
    tt = tuple(Shard(2) if p == Shard(1) else p for p in ht)   # (B,T,H,..)
    st = tuple(Shard(p.dim + 1) if isinstance(p, Shard) else p for p in ht)
    return local_kernel(fn, [h, dA, xdt, Bh, Ch], [ht, tt, tt, tt, tt],
                        [tt, ht, st])


def _head_plan(mesh, qt, kt, Hq: int, Hkv: int):
    """Placements of the queries and of a KV tensor (heads at dim 2 of
    both) under which each rank's query heads meet their KV heads: a KV
    head split where the queries are whole is gathered; where the queries
    are split and the KV heads whole, the rank slices its one KV head if
    its query heads lie in one group (``slice_on`` = (mesh dim, query
    heads a rank)), else the queries are gathered."""
    group = Hq // Hkv
    slice_on = None
    for i, (pq, pk) in enumerate(zip(qt, kt)):
        if isinstance(pq, Shard) and pq.dim == 2 and not (
                isinstance(pk, Shard) and pk.dim == 2):
            per_rank = Hq // mesh.size(i)
            if group % per_rank == 0 and slice_on is None:
                slice_on = (i, per_rank)        # this rank's heads: one group
            else:
                qt = qt[:i] + (Replicate(),) + qt[i + 1:]
        elif isinstance(pk, Shard) and pk.dim == 2 and not (
                isinstance(pq, Shard) and pq.dim == 2):
            kt = kt[:i] + (Replicate(),) + kt[i + 1:]
    return qt, kt, slice_on


def _kv_head(mesh, slice_on, group: int):
    """(first, last + 1) of the KV heads this rank's queries read."""
    if slice_on is None:
        return None
    i, per_rank = slice_on
    head = mesh.get_local_rank(mesh_shape(mesh).axis_names[i]) \
        * per_rank // group
    return head, head + 1


def _batch_of(pl):
    """Placements keeping only a split of dim 0."""
    return tuple(p if p == Shard(0) else Replicate() for p in pl)


def local_attention(local: Callable, q, k, v, **kw):
    """``local(q (B,S,Hq,D), k, v (B,S,Hkv,D), **kw)`` on local blocks of
    batch and heads -> (B,S,Hq,D) placed as the query blocks."""
    mesh = q.device_mesh
    Hq, Hkv = q.shape[2], k.shape[2]
    qt, kt, slice_on = _head_plan(mesh, _keep(q.placements, (0, 2)),
                                  _keep(k.placements, (0, 2)), Hq, Hkv)
    # the batch split must agree
    kt = tuple(pq if isinstance(pq, Shard) and pq.dim == 0 else pk
               for pq, pk in zip(qt, kt))
    if slice_on is None:
        return local_kernel(
            lambda ql, kl, vl: local(ql.contiguous(), kl.contiguous(),
                                     vl.contiguous(), **kw),
            [q, k, v], [qt, kt, kt], [qt])
    head, _ = _kv_head(mesh, slice_on, Hq // Hkv)
    kg = tuple(Partial() if j == slice_on[0] else p for j, p in enumerate(kt))

    def body(ql, kl, vl):
        return local(ql.contiguous(), kl[:, :, head:head + 1].contiguous(),
                     vl[:, :, head:head + 1].contiguous(), **kw)
    return local_kernel(body, [q, k, v], [qt, kt, kt], [qt],
                        grads=[qt, kg, kg])


def paged_attention(attn: Callable, q, pool, page_rows, qpos, **kw):
    """``attn(q (B,T,Hq,D), k_pool, v_pool, pos_pool, page_rows (B,n),
    qpos (B,T), **kw)``, the paged-attention kernel's wrapper, on local
    blocks -> (B,T,Hq,D) placed as the query blocks. ``pool`` is a
    ``PagedKVCache`` of DTensors, ``page_rows`` and ``qpos`` whole plain
    tensors (global page ids)."""
    mesh = q.device_mesh
    Hq, Hkv = q.shape[2], pool.k.shape[2]
    qt, kt, slice_on = _head_plan(mesh, _keep(q.placements, (0, 2)),
                                  _keep(pool.k.placements, (2,)), Hq, Hkv)
    bt = _batch_of(qt)
    whole = (Replicate(),) * mesh.ndim
    span = _kv_head(mesh, slice_on, Hq // Hkv)
    n = pool.per_shard

    def body(ql, kl, vl, pl, rl, ql_pos):
        rows = torch.where(rl >= 0, rl + torch.div(rl, n, rounding_mode="floor"),
                           rl)
        if span is not None:
            kl = kl[:, :, span[0]:span[1]].contiguous()
            vl = vl[:, :, span[0]:span[1]].contiguous()
        return attn(ql.contiguous(), kl, vl, pl, rows.contiguous(),
                    ql_pos.contiguous(), **kw)
    return local_kernel(
        body, [q, pool.k, pool.v, pool.pos, distribute(page_rows, mesh, bt),
               distribute(qpos, mesh, bt)],
        [qt, kt, kt, whole, bt, bt], [qt])


def attend_masked(fn: Callable, q, k_all, v_all, kp, qpos):
    """``fn(q (B,Sq,Hq,D), k_all, v_all (B,L,Hkv,D), kp (B,L), qpos
    (B,Sq))``, the ring's masked attention, on local blocks of batch and
    heads, the ring's sequence axis whole -> placed as the query blocks.
    ``qpos`` is a whole plain tensor."""
    mesh = q.device_mesh
    Hq, Hkv = q.shape[2], k_all.shape[2]
    qt, kt, slice_on = _head_plan(mesh, _keep(q.placements, (0, 2)),
                                  _keep(k_all.placements, (0, 2)), Hq, Hkv)
    # the ring's rows follow the queries' batch split
    kt = tuple(Shard(0) if pq == Shard(0) else
               (Replicate() if pk == Shard(0) else pk)
               for pq, pk in zip(qt, kt))
    bt = _batch_of(qt)
    span = _kv_head(mesh, slice_on, Hq // Hkv)

    def body(ql, kl, vl, pl, qpl):
        if span is not None:
            kl, vl = kl[:, :, span[0]:span[1]], vl[:, :, span[0]:span[1]]
        return fn(ql, kl, vl, pl, qpl)
    return local_kernel(body, [q, k_all, v_all, kp, distribute(qpos, mesh, bt)],
                        [qt, kt, kt, bt, bt], [qt])
