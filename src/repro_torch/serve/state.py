"""InferenceState: what the paged inference engine owns.

The port of the paged part of ``repro/serve/state.py``: model parameters
(already cast as the steps use them, ``transformer.cast_params``), one
page pool per attention layer, a per-slot ``page_table`` (S,
pages_per_slot) of physical page ids (-1 free), and the per-slot position
counter and last token. Slot count is decoupled from cache length: KV
memory follows live tokens, not ``slots * max_len``.

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
    cache: List[PagedKVCache]   # tfm.init_paged_cache: one pool per layer
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
    go to the sink page."""
    for pool in cache:
        pool.pos[torch.where(pages >= 0, pages, pool.num_pages).long()] = -1


def select_verified(stacked: List[Any], old: List[Any], n: torch.Tensor,
                    active: torch.Tensor) -> List[Any]:
    """Roll the cache back to each slot's last accepted token after a
    speculative verify step. Attention page pools need nothing: rejected
    writes are shadowed by the position mask until the real sequence
    overwrites them. (The per-step recurrent/SSM snapshots the reference
    selects from here are not ported.)"""
    for entry in stacked:
        if not isinstance(entry, PagedKVCache):
            raise NotImplementedError("recurrent state roll-back is not "
                                      "ported yet (ROADMAP Queue A)")
    return stacked
