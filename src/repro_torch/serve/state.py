"""InferenceState: what the paged inference engine owns.

The port of the paged part of ``repro/serve/state.py``: model parameters
(already cast as the steps use them, ``transformer.cast_params``), one
page pool per attention layer and slot-major float32 state per recurrent
or SSM layer, a per-slot ``page_table`` (S, pages_per_slot) of physical
page ids (-1 free), and the per-slot position counter and last token.
Slot count is decoupled from cache length: KV memory follows live tokens,
not ``slots * max_len``.

The reference threads the state through jitted, donated steps and gets a
new one back from each; the port updates the tensors in place and hands
the same state object back. The contiguous (slot-major ring) layout and
the per-slot sampling arrays are not ported: the engine serves paged and
greedy only.
"""
from __future__ import annotations

from typing import Any, List, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import PagedKVCache


class InferenceState(NamedTuple):
    params: Any
    cache: List[Any]            # tfm.init_paged_cache: a pool or a state per layer
    positions: torch.Tensor     # (S,) int32: next write index per slot
    last_tok: torch.Tensor      # (S,) int32: last accepted/emitted token
    page_table: torch.Tensor    # (S, pages_per_slot) int32, -1 free


def new_paged_inference_state(params: Any, cfg: ModelConfig, *, slots: int,
                              num_pages: int, pages_per_slot: int,
                              page_size: int, dtype=torch.bfloat16,
                              device="cpu") -> InferenceState:
    """Fresh paged state: empty page pool, all page-table entries free."""
    def zeros():
        return torch.zeros((slots,), dtype=torch.int32, device=device)
    return InferenceState(
        params=params,
        cache=tfm.init_paged_cache(cfg, slots, num_pages, page_size,
                                   dtype=dtype, device=device),
        positions=zeros(),
        last_tok=zeros(),
        page_table=torch.full((slots, pages_per_slot), -1, dtype=torch.int32,
                              device=device),
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
