"""The LM kernels on a mesh: each wrapper called on local blocks through
``local_map`` (``sharding.local_kernel``), with placements that keep its
work local.

* the causal conv1d is depthwise: a block of the batch and of the
  channels needs only its channels' taps and bias, so the rules' split of
  the channels (``inner`` on "model") is kept, and the weights follow it;
* the chunked SSD scan around the SSD-chunk kernel is per head: batch
  and heads stay split, each rank takes the ``B``/``C`` groups of its
  heads, and ``A``, ``D`` follow the heads;
* local attention is per head too: batch and query heads stay split.
  Where the KV heads are split alike, each rank's query groups meet their
  own KV heads. Where the KV heads are whole (``kv_heads`` does not divide
  the model axis) and each rank's query heads fall in one KV group, the
  rank slices that KV head; otherwise the query heads are gathered.

Any other split (a sequence split) is gathered before the call. A weight
that is whole on a mesh dim splitting the batch gets a Partial gradient
there, which the engine reduces.
"""
from __future__ import annotations

from typing import Callable, Optional

from torch.distributed.tensor import Partial, Replicate, Shard

from repro_torch.distributed.sharding import (
    local_kernel, mesh_shape, weight_grad_placements,
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


def local_attention(local: Callable, q, k, v, **kw):
    """``local(q (B,S,Hq,D), k, v (B,S,Hkv,D), **kw)`` on local blocks of
    batch and heads -> (B,S,Hq,D) placed as the query blocks."""
    mesh = q.device_mesh
    names = mesh_shape(mesh).axis_names
    qt = _keep(q.placements, (0, 2))
    kt = _keep(k.placements, (0, 2))
    Hq, Hkv = q.shape[2], k.shape[2]
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
    # the batch split must agree
    kt = tuple(pq if isinstance(pq, Shard) and pq.dim == 0 else pk
               for pq, pk in zip(qt, kt))
    if slice_on is None:
        return local_kernel(
            lambda ql, kl, vl: local(ql.contiguous(), kl.contiguous(),
                                     vl.contiguous(), **kw),
            [q, k, v], [qt, kt, kt], [qt])
    i, per_rank = slice_on
    rank = mesh.get_local_rank(names[i])
    head = rank * per_rank // group
    kg = tuple(Partial() if j == i else p for j, p in enumerate(kt))

    def body(ql, kl, vl):
        return local(ql.contiguous(), kl[:, :, head:head + 1].contiguous(),
                     vl[:, :, head:head + 1].contiguous(), **kw)
    return local_kernel(body, [q, k, v], [qt, kt, kt], [qt],
                        grads=[qt, kg, kg])

