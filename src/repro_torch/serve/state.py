"""InferenceState: what the paged inference engine owns.

The port of the paged part of ``repro/serve/state.py``: model parameters
(already cast as the steps use them, ``transformer.cast_params``), one
page pool per attention layer and slot-major float32 state per recurrent
or SSM layer, a per-slot ``page_table`` (S, pages_per_slot) of physical
page ids (-1 free), the per-slot position counter and last token, and
the per-slot sampling rows (``serve/sampling.py``): temperature, top-k,
top-p, repetition penalty, the raw threefry key and the
repetition-penalty presence row over the padded vocab. Slot count is
decoupled from cache length: KV memory follows live tokens, not
``slots * max_len``.

The reference threads the state through jitted, donated steps and gets a
new one back from each; the port updates the tensors in place and hands
the same state object back. A hook that restores rows (``swap_in``,
``restore_pages``, ``set_slot_state``) writes into the existing tensors
and never rebinds them. The contiguous (slot-major ring) layout is not
ported.

Host blobs (the preemption swap blob, the host tier's spilled pages, the
prefix cache's recurrent snapshots) keep the reference's layout: a list
of numpy arrays aligned with the leaves of the reference's cache pytree
(``cache_leaves``), ``None`` where a leaf is slot-major (page rows) or
paged (slot rows), the ``pos`` leaf travelling with the KV rows. A
bfloat16 leaf travels as its bits in ``uint16`` (numpy has no bfloat16).
"""
from __future__ import annotations

from typing import Any, List, NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import ATTN_GLOBAL, ATTN_LOCAL, ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import PagedKVCache


class InferenceState(NamedTuple):
    params: Any
    cache: List[Any]            # tfm.init_paged_cache: a pool or a state per layer
    positions: torch.Tensor     # (S,) int32: next write index per slot
    last_tok: torch.Tensor      # (S,) int32: last accepted/emitted token
    page_table: torch.Tensor    # (S, pages_per_slot) int32, -1 free
    # per-slot sampling rows: temperature <= 0 is the greedy path
    sample_temp: torch.Tensor   # (S,) float32
    sample_top_k: torch.Tensor  # (S,) int32, 0 = off
    sample_top_p: torch.Tensor  # (S,) float32, 1.0 = off
    sample_rep: torch.Tensor    # (S,) float32 repetition penalty, 1.0 = off
    sample_key: torch.Tensor    # (S, 2) int64 holding the uint32 key words
    tok_presence: torch.Tensor  # (S, padded_vocab) bool
    # host copy of sample_temp: the steps gate the sampler on it without
    # reading the device
    temp_host: np.ndarray       # (S,) float32


def new_paged_inference_state(params: Any, cfg: ModelConfig, *, slots: int,
                              num_pages: int, pages_per_slot: int,
                              page_size: int, dtype=torch.bfloat16,
                              device="cpu") -> InferenceState:
    """Fresh paged state: empty page pool, all page-table entries free,
    every slot greedy."""
    def full(shape, value, dt):
        return torch.full(shape, value, dtype=dt, device=device)
    return InferenceState(
        params=params,
        cache=tfm.init_paged_cache(cfg, slots, num_pages, page_size,
                                   dtype=dtype, device=device),
        positions=full((slots,), 0, torch.int32),
        last_tok=full((slots,), 0, torch.int32),
        page_table=full((slots, pages_per_slot), -1, torch.int32),
        sample_temp=full((slots,), 0.0, torch.float32),
        sample_top_k=full((slots,), 0, torch.int32),
        sample_top_p=full((slots,), 1.0, torch.float32),
        sample_rep=full((slots,), 1.0, torch.float32),
        sample_key=full((slots, 2), 0, torch.int64),
        tok_presence=full((slots, cfg.padded_vocab()), False, torch.bool),
        temp_host=np.zeros((slots,), np.float32),
    )


def clear_pages(cache: List[PagedKVCache], pages: torch.Tensor) -> None:
    """Reset the position metadata of ``pages`` in every layer pool, in
    place, so a page recycled from an evicted request can never leak stale
    entries into its new owner's attention mask (positions are the only
    validity record — k/v bytes are inert once pos is -1). Negative ids
    go to the sink page. Recurrent and SSM state holds no pages."""
    for pool in cache:
        if isinstance(pool, PagedKVCache):
            pool.pos[torch.where(pages >= 0, pages, pool.num_pages).long()] = -1


def select_verified(stacked: List[Any], old: List[Any], n: torch.Tensor,
                    active: torch.Tensor) -> List[Any]:
    """Roll the cache back to each slot's last accepted token after a
    speculative verify step, in place, and return ``old``.

    ``stacked`` is the cache list ``transformer.verify_step_paged``
    returned: attention page pools are final (rejected writes are
    shadowed by the position mask until the real sequence overwrites
    them — nothing to undo), while recurrent/SSM entries carry the state
    after every proposed token on a leading step axis. ``n`` (S,) is the
    number of accepted drafts per slot: snapshot ``n[s]`` is the state
    after consuming the last accepted token. Each active slot's row of
    ``old`` takes that snapshot; inactive slots keep their rows."""
    rows = torch.arange(n.shape[0], device=n.device)
    idx = n.long()
    for st, o in zip(stacked, old):
        if isinstance(st, PagedKVCache):
            continue
        for snap, leaf in zip(st, o):
            sel = snap[idx, rows]                               # (S, ...)
            m = active.reshape((-1,) + (1,) * (sel.dim() - 1))
            leaf.copy_(torch.where(m, sel.to(leaf.dtype), leaf))
    return old


# ---------------------------------------------------------------------------
# Page and slot rows: the host blobs of the policy hooks
# ---------------------------------------------------------------------------
class CacheLeaf(NamedTuple):
    """One leaf of the reference's cache pytree over the port's per-layer
    list: ``field`` of the layers ``layers`` (port layer indices), stacked
    on a leading axis where the reference scans them (``stacked``), and
    whether the leaf is a page pool's (``paged``) or a slot-major state's."""
    field: str
    layers: tuple
    stacked: bool
    paged: bool


def cache_leaves(cfg: ModelConfig) -> List[CacheLeaf]:
    """The leaves of the reference's ``init_paged_cache`` tree in its
    flattening order: a dict ``{"blocks", "prefix", "suffix"}`` (keys
    sorted), ``blocks`` a dict over the pattern's positions (keys sorted
    as strings) whose leaves carry the repetitions on a leading axis,
    ``prefix``/``suffix`` tuples; each layer a ``PagedKVCache`` (k, v,
    pos) or a recurrent/SSM state (h, conv)."""
    prefix, pat, n_rep, suffix = tfm.stack_plan(cfg)

    def one(kind, layers, stacked):
        paged = kind in (ATTN_GLOBAL, ATTN_LOCAL)
        fields = ("k", "v", "pos") if paged else ("h", "conv")
        return [CacheLeaf(f, tuple(layers), stacked, paged) for f in fields]

    groups = {}
    if prefix:
        groups["prefix"] = [leaf for i, k in enumerate(prefix)
                            for leaf in one(k, [i], False)]
    if n_rep:
        first = len(prefix)
        groups["blocks"] = [
            leaf for i in sorted(range(len(pat)), key=str)
            for leaf in one(pat[i], [first + r * len(pat) + i
                                     for r in range(n_rep)], True)]
    if suffix:
        first = len(prefix) + n_rep * len(pat)
        groups["suffix"] = [leaf for i, k in enumerate(suffix)
                            for leaf in one(k, [first + i], False)]
    return [leaf for name in sorted(groups) for leaf in groups[name]]


def _to_host(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


def _to_device(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if like.dtype == torch.bfloat16:
        if a.dtype != np.uint16:
            raise ValueError(f"a bfloat16 leaf travels as uint16 bits, "
                             f"got {a.dtype}")
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=like.device, dtype=like.dtype)


def _tensor(cache: List[Any], leaf: CacheLeaf, layer: int) -> torch.Tensor:
    return getattr(cache[layer], leaf.field)


def _index(ids, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(ids, np.int64).ravel(), device=device)


def _gather(cache, leaves, pick, want_paged: bool) -> list:
    out = []
    for leaf in leaves:
        if leaf.paged != want_paged:
            out.append(None)
            continue
        rows = [pick(_tensor(cache, leaf, i)) for i in leaf.layers]
        out.append(_to_host(torch.stack(rows) if leaf.stacked else rows[0]))
    return out


def _scatter(cache, leaves, rows, put, want_paged: bool) -> None:
    if len(rows) != len(leaves):
        raise ValueError(f"blob has {len(rows)} leaves, the cache "
                         f"{len(leaves)}")
    for leaf, r in zip(leaves, rows):
        if r is None:
            continue
        if leaf.paged != want_paged:
            raise ValueError(f"blob leaf '{leaf.field}' of layers "
                             f"{leaf.layers} is on the wrong side")
        t = _to_device(r, _tensor(cache, leaf, leaf.layers[0]))
        for j, i in enumerate(leaf.layers):
            put(_tensor(cache, leaf, i), t[j] if leaf.stacked else t)


def copy_pool_pages(cache: List[Any], src, dst) -> None:
    """Copy-on-write, in place: duplicate pool pages ``src`` into ``dst``
    across every page pool — k, v AND pos, so the new owner's reads see
    the original pages' entries while its writes land in private copies.
    Recurrent/SSM state holds no pages."""
    for pool in cache:
        if isinstance(pool, PagedKVCache):
            s = _index(src, pool.k.device)
            d = _index(dst, pool.k.device)
            for t in pool:
                t[d] = t[s]


def gather_page_rows(cache: List[Any], leaves: List[CacheLeaf],
                     pages) -> list:
    """Host copies of pool rows ``pages`` from every paged leaf, as a
    ``cache_leaves``-aligned list (``None`` for slot-major leaves): the
    swap-out half of page-aware preemption and the host tier's spill —
    just these rows, never the whole pool."""
    idx = _index(pages, cache[0][0].device)
    return _gather(cache, leaves, lambda t: t.index_select(0, idx), True)


def concat_page_rows(leaves: List[CacheLeaf], blobs: list) -> list:
    """Merge per-page ``gather_page_rows`` blobs into one multi-page blob
    along each leaf's pages axis (after the repetition axis of a stacked
    leaf), so a multi-page restore is one host-to-device copy a leaf."""
    if not blobs:
        raise ValueError("concat_page_rows needs at least one blob")
    out = []
    for li, leaf in enumerate(leaves):
        parts = [b[li] for b in blobs]
        out.append(None if parts[0] is None else
                   np.concatenate(parts, axis=1 if leaf.stacked else 0))
    return out


def scatter_page_rows(cache: List[Any], leaves: List[CacheLeaf], pages,
                      rows: list) -> None:
    """Write a ``gather_page_rows`` blob into pool pages ``pages``, in
    place. The physical ids may differ from the ones the blob was gathered
    at: page contents are keyed by absolute positions (the pos leaf
    travels in the blob), not by page id."""
    idx = _index(pages, cache[0][0].device)

    def put(t, r):
        t[idx] = r
    _scatter(cache, leaves, rows, put, True)


def gather_slot_rows(cache: List[Any], leaves: List[CacheLeaf],
                     slot: int) -> list:
    """Host copies of row ``slot`` of every slot-major (recurrent/SSM)
    leaf, ``cache_leaves``-aligned (``None`` for paged leaves): the prefix
    cache's snapshot at a page boundary and the recurrent half of a swap
    blob."""
    s = int(slot)
    return _gather(cache, leaves, lambda t: t[s], False)


def scatter_slot_rows(cache: List[Any], leaves: List[CacheLeaf], slot: int,
                      rows: list) -> None:
    """Write a ``gather_slot_rows`` blob into row ``slot`` (any slot), in
    place."""
    s = int(slot)

    def put(t, r):
        t[s] = r
    _scatter(cache, leaves, rows, put, False)
