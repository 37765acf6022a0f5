"""InferenceState: what the inference engine owns.

The port of ``repro/serve/state.py``: model parameters (already cast as
the steps use them, ``transformer.cast_params``), the cache, the per-slot
position counter and last token, and the per-slot sampling rows
(``serve/sampling.py``): temperature, top-k, top-p, repetition penalty,
the raw threefry key and the repetition-penalty presence row over the
padded vocab. In the paged layout the cache is one page pool per
attention layer and slot-major float32 state per recurrent or SSM layer,
with a per-slot ``page_table`` (S, pages_per_slot) of physical page ids
(-1 free): slot count is decoupled from cache length, KV memory follows
live tokens, not ``slots * max_len``. In the contiguous layout (the
reference's parity baseline, ``new_inference_state``) each attention
layer keeps a slot-major ring of ``max_len`` (a local layer's window) and
there is no page table; a prefill's cache goes into its slot's row
(``scatter_slot``).

``inference_state_axes`` and ``paged_inference_state_axes`` give the
logical axes of every leaf (the params' ``transformer.param_specs``, the
cache's ``cache_axes``/``paged_cache_axes``, ``("batch",)`` for the
per-slot rows), from which the engine places the state on a mesh. There
the row helpers below work on local blocks (``distributed/sharding.py``'s
``take_rows``/``put_rows``): a page id names a storage row of a pool whose
shards each keep a sink (``models/attention.py::storage_ids``).

The reference threads the state through jitted, donated steps and gets a
new one back from each; the port updates the tensors in place and hands
the same state object back. A hook that restores rows (``swap_in``,
``restore_pages``, ``set_slot_state``) writes into the existing tensors
and never rebinds them.

Host blobs (the preemption swap blob, the host tier's spilled pages, the
prefix cache's recurrent snapshots) keep the reference's layout: a list
of numpy arrays aligned with the leaves of the reference's cache pytree
(``cache_leaves``), ``None`` where a leaf is slot-major (page rows) or
paged (slot rows), the ``pos`` leaf travelling with the KV rows. A
bfloat16 leaf travels as its bits in ``uint16`` (numpy has no bfloat16).
"""
from __future__ import annotations

from typing import Any, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import ATTN_GLOBAL, ATTN_LOCAL, ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import PagedKVCache, storage_ids


class InferenceState(NamedTuple):
    params: Any
    cache: List[Any]            # tfm.init_paged_cache / init_cache: an entry a layer
    positions: torch.Tensor     # (S,) int32: next write index per slot
    last_tok: torch.Tensor      # (S,) int32: last accepted/emitted token
    page_table: Any             # paged: (S, pages_per_slot) int32, -1 free; else None
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


_SAMPLING_AXES = dict(
    sample_temp=("batch",), sample_top_k=("batch",),
    sample_top_p=("batch",), sample_rep=("batch",),
    sample_key=("batch", None), tok_presence=("batch", None),
)


def inference_state_axes(cfg: ModelConfig) -> InferenceState:
    """Logical axes of every leaf of a contiguous state: the params'
    (training's placement), the rings' and states' (``cache_axes``, whose
    ``cache_seq`` axis takes the ``cache_needs_seq_shard`` branch), the
    per-slot rows on ``batch``; ``temp_host`` is on the host."""
    return InferenceState(
        params=tfm.param_specs(cfg), cache=tfm.cache_axes(cfg),
        positions=("batch",), last_tok=("batch",), page_table=None,
        temp_host=None, **_SAMPLING_AXES)


def paged_inference_state_axes(cfg: ModelConfig) -> InferenceState:
    """Logical axes of a paged state: the pools on "pages" / "cache_seq"
    (the latter keeps the ``cache_needs_seq_shard`` branch), the page
    table on the slot (``batch``) axis."""
    return inference_state_axes(cfg)._replace(
        cache=tfm.paged_cache_axes(cfg), page_table=("batch", None))


def _slot_rows(cfg: ModelConfig, slots: int, device) -> dict:
    """Fresh per-slot rows: counters at 0, every slot greedy."""
    def full(shape, value, dt):
        return torch.full(shape, value, dtype=dt, device=device)
    return dict(
        positions=full((slots,), 0, torch.int32),
        last_tok=full((slots,), 0, torch.int32),
        sample_temp=full((slots,), 0.0, torch.float32),
        sample_top_k=full((slots,), 0, torch.int32),
        sample_top_p=full((slots,), 1.0, torch.float32),
        sample_rep=full((slots,), 1.0, torch.float32),
        sample_key=full((slots, 2), 0, torch.int64),
        tok_presence=full((slots, cfg.padded_vocab()), False, torch.bool),
        temp_host=np.zeros((slots,), np.float32),
    )


def new_inference_state(params: Any, cfg: ModelConfig, *, slots: int,
                        max_len: int, dtype=torch.bfloat16,
                        device="cpu") -> InferenceState:
    """Fresh contiguous state: empty rings of ``max_len``, every slot
    greedy."""
    return InferenceState(
        params=params,
        cache=tfm.init_cache(cfg, slots, max_len, dtype=dtype, device=device),
        page_table=None, **_slot_rows(cfg, slots, device))


def new_paged_inference_state(params: Any, cfg: ModelConfig, *, slots: int,
                              num_pages: int, pages_per_slot: int,
                              page_size: int, dtype=torch.bfloat16,
                              device="cpu", shards: int = 1) -> InferenceState:
    """Fresh paged state: empty page pool, all page-table entries free,
    every slot greedy."""
    return InferenceState(
        params=params,
        cache=tfm.init_paged_cache(cfg, slots, num_pages, page_size,
                                   dtype=dtype, device=device, shards=shards),
        page_table=torch.full((slots, pages_per_slot), -1, dtype=torch.int32,
                              device=device),
        **_slot_rows(cfg, slots, device))


def scatter_slot(full: List[Any], one: List[Any], slot: int) -> List[Any]:
    """Write a one-request cache ``one`` (``transformer.prefill``'s, batch
    1) into row ``slot`` of the contiguous cache ``full``, entry by entry
    and leaf by leaf, in place; returns ``full``."""
    rows = shd.Rows([slot])
    for f_entry, o_entry in zip(full, one):
        for f, o in zip(f_entry, o_entry):
            shd.put_rows(f, rows, shd.full(o)[:1])
    return full


def clear_pages(cache: List[PagedKVCache], pages) -> None:
    """Reset the position metadata of ``pages`` (host ids) in every layer
    pool, in place, so a page recycled from an evicted request can never
    leak stale entries into its new owner's attention mask (positions are
    the only validity record — k/v bytes are inert once pos is -1).
    Negative ids name no page. Recurrent and SSM state holds no pages."""
    pages = [int(g) for g in np.asarray(pages).ravel() if g >= 0]
    rows = _page_rows(cache, pages)
    for pool in cache:
        if isinstance(pool, PagedKVCache) and pages:
            shd.put_rows(pool.pos, rows, torch.full(
                (len(pages),) + tuple(pool.pos.shape[1:]), -1,
                dtype=torch.int32, device=shd.local(pool.pos).device))


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
    ``old`` takes that snapshot; inactive slots keep their rows. On a mesh
    this runs on each rank's block of slots: ``n`` and ``active`` are
    whole, the snapshots are placed as their rows."""
    for st, o in zip(stacked, old):
        if isinstance(st, PagedKVCache):
            continue
        for snap, leaf in zip(st, o):
            start, size = (shd.shard_range(leaf, 0)
                           if shd.is_distributed(leaf) else (0, leaf.shape[0]))
            snap, loc = shd.local(shd.stacked_like(snap, leaf)), shd.local(leaf)
            rows = torch.arange(size, device=loc.device)
            sel = snap[n[start:start + size].long(), rows]      # (S, ...)
            m = active[start:start + size].reshape(
                (-1,) + (1,) * (sel.dim() - 1))
            loc.copy_(torch.where(m, sel.to(loc.dtype), loc))
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


def _ids(ids) -> list:
    return [int(i) for i in np.asarray(ids, np.int64).ravel()]


def _page_rows(cache: List[Any], pages: list) -> Optional[shd.Rows]:
    """The storage rows of page ids ``pages`` (``storage_ids``), alike in
    every pool of ``cache`` (one ``shards`` for all), as one
    ``sharding.Rows``, so a hook makes its index once; None without a
    pool."""
    pool = next((c for c in cache if isinstance(c, PagedKVCache)), None)
    return None if pool is None else shd.Rows(storage_ids(pool, pages))


def _rows_of(cache: List[Any], ids: list, paged: bool) -> Optional[shd.Rows]:
    """The rows of ``ids``: page ids of the pools, else slot ids."""
    return _page_rows(cache, ids) if paged else shd.Rows(ids)


def _gather(cache, leaves, ids: list, want_paged: bool,
            squeeze: bool) -> list:
    out = []
    at = _rows_of(cache, ids, want_paged)
    for leaf in leaves:
        if leaf.paged != want_paged:
            out.append(None)
            continue
        rows = [shd.take_rows(_tensor(cache, leaf, i), at)
                for i in leaf.layers]
        if squeeze:
            rows = [r[0] for r in rows]
        out.append(_to_host(torch.stack(rows) if leaf.stacked else rows[0]))
    return out


def _scatter(cache, leaves, rows, ids: list, want_paged: bool,
             squeeze: bool) -> None:
    if len(rows) != len(leaves):
        raise ValueError(f"blob has {len(rows)} leaves, the cache "
                         f"{len(leaves)}")
    at = _rows_of(cache, ids, want_paged)
    for leaf, r in zip(leaves, rows):
        if r is None:
            continue
        if leaf.paged != want_paged:
            raise ValueError(f"blob leaf '{leaf.field}' of layers "
                             f"{leaf.layers} is on the wrong side")
        t = _to_device(r, _tensor(cache, leaf, leaf.layers[0]))
        for j, i in enumerate(leaf.layers):
            v = t[j] if leaf.stacked else t
            shd.put_rows(_tensor(cache, leaf, i), at,
                         v[None] if squeeze else v)


def copy_pool_pages(cache: List[Any], src, dst) -> None:
    """Copy-on-write, in place: duplicate pool pages ``src`` into ``dst``
    across every page pool — k, v AND pos, so the new owner's reads see
    the original pages' entries while its writes land in private copies.
    Recurrent/SSM state holds no pages."""
    s, d = _page_rows(cache, _ids(src)), _page_rows(cache, _ids(dst))
    for pool in cache:
        if isinstance(pool, PagedKVCache):
            for t in pool:
                shd.put_rows(t, d, shd.take_rows(t, s))


def gather_page_rows(cache: List[Any], leaves: List[CacheLeaf],
                     pages) -> list:
    """Host copies of pool rows ``pages`` from every paged leaf, as a
    ``cache_leaves``-aligned list (``None`` for slot-major leaves): the
    swap-out half of page-aware preemption and the host tier's spill —
    just these rows, never the whole pool."""
    return _gather(cache, leaves, _ids(pages), True, False)


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
    _scatter(cache, leaves, rows, _ids(pages), True, False)


def gather_slot_rows(cache: List[Any], leaves: List[CacheLeaf],
                     slot: int) -> list:
    """Host copies of row ``slot`` of every slot-major (recurrent/SSM)
    leaf, ``cache_leaves``-aligned (``None`` for paged leaves): the prefix
    cache's snapshot at a page boundary and the recurrent half of a swap
    blob."""
    return _gather(cache, leaves, [int(slot)], False, True)


def scatter_slot_rows(cache: List[Any], leaves: List[CacheLeaf], slot: int,
                      rows: list) -> None:
    """Write a ``gather_slot_rows`` blob into row ``slot`` (any slot), in
    place."""
    _scatter(cache, leaves, rows, [int(slot)], False, True)
