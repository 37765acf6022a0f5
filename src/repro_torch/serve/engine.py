"""The paged inference engine: prefill-insert, chunked insert, fused
all-slot decode and speculative verify over request slots, on one device.

The port of ``repro/serve/engine.py::InferenceEngine`` in paged mode. It
exposes the surface the scheduler (``serve/scheduler.py``, a copy of the
reference's) calls:

  * attributes ``paged``, ``page_size``, ``num_pages``, ``pages_per_slot``,
    ``slots``, ``max_len``, ``prefill_chunk``, ``has_recurrent_state``;
  * ``assign_pages`` / ``release_pages`` (page-table installs, host-side
    policy hooks), ``set_sampling`` (greedy only);
  * ``insert`` (whole-prompt prefill at the exact prompt length, its ring
    cache scattered into the slot's pages and its recurrent/SSM state into
    the slot's row), ``insert_chunk`` (one prompt chunk written through
    the slot's page row and state row), ``decode`` (one token for every
    slot, ``active`` gating every write) and ``verify`` (one forward over
    each slot's last token plus K drafts, greedy acceptance, recurrent
    rows rolled back to the last accepted token).

The reference's steps are jitted and donated; the port runs them eagerly
under ``torch.inference_mode`` and updates the state's tensors in place.
Token outputs come back as numpy arrays, which is where a step waits for
the device. Prefix-cache, preemption and host-tier hooks (``copy_pages``,
``get/set_slot_state``, ``swap_out/swap_in``, ``spill_page``,
``restore_pages``) raise ``NotImplementedError``: ROADMAP Queue A,
item 4. The contiguous (unpaged) layout is not ported: ``paged`` is
always True.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``); without a card they raise. ``ops=transformer.PLAIN``
serves only to hold the kernels' run against their plain versions on the
card.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import RECURRENT, SSM, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.serve import sampling
from repro_torch.serve.state import (
    InferenceState, clear_pages, new_paged_inference_state, select_verified,
)

_ROADMAP = "not ported yet (ROADMAP Queue A, item 4)"


class InferenceEngine:
    """Paged prefill/decode/verify steps over request slots on one device.

    A pool of ``num_pages`` pages of ``page_size`` tokens per attention
    layer plus per-slot page tables decouple slot count from ``max_len``;
    ``prefill_chunk`` admits long prompts that many tokens at a time
    through :meth:`insert_chunk`, so the scheduler can interleave
    admission with fused decode steps."""

    def __init__(self, cfg: ModelConfig, *, slots: int = 4,
                 max_len: int = 64, dtype: torch.dtype = torch.bfloat16,
                 page_size: int = 16,
                 num_pages: Optional[int] = None, prefill_chunk: int = 0,
                 device: str | torch.device = "cuda",
                 ops: tfm.KernelOps = tfm.KERNELS):
        if not cfg.supports_decode():
            raise ValueError(f"{cfg.name} has no decode path")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        tfm.layer_plan(cfg)            # raises for layers not ported yet
        self.cfg = cfg
        self.device = resolve_device(device)
        self.ops = ops
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.dtype = dtype
        self.paged = True
        self.prefill_chunk = int(prefill_chunk)
        self.page_size = int(page_size)
        self.pages_per_slot = -(-self.max_len // self.page_size)
        self.num_pages = int(num_pages) if num_pages \
            else self.slots * self.pages_per_slot

    # -- state lifecycle ---------------------------------------------------
    def init_state(self, params: Any) -> InferenceState:
        """Fresh state around ``params`` (the reference's tree as
        ``convert.params_from_jax`` gives it, or ``transformer.init``'s),
        cast once as the steps use them and placed on the device."""
        return new_paged_inference_state(
            tfm.cast_params(params, self.dtype, self.device), self.cfg,
            slots=self.slots, num_pages=self.num_pages,
            pages_per_slot=self.pages_per_slot, page_size=self.page_size,
            dtype=self.dtype, device=self.device)

    def assign_pages(self, state: InferenceState, slot: int, pages,
                     fresh=None) -> InferenceState:
        """Install ``pages`` (ordered physical page ids from the
        scheduler's free list) as ``slot``'s page row, and reset the
        position metadata of the FRESH ones (default: all of ``pages``) in
        every layer pool: a page recycled from an evicted request must
        never leak stale entries into its new owner's attention mask."""
        row = np.full((self.pages_per_slot,), -1, np.int32)
        row[:len(pages)] = pages
        state.page_table[slot] = torch.from_numpy(row).to(self.device)
        clear = list(pages) if fresh is None else list(fresh)
        if clear:
            clear_pages(state.cache, torch.tensor(clear, dtype=torch.int32,
                                                  device=self.device))
        return state

    def release_pages(self, state: InferenceState,
                      slot: int) -> InferenceState:
        """Clear ``slot``'s page row on eviction: a cleared row (-1) sends
        any later write through this slot to the sink page instead of
        into the pages' new owner."""
        state.page_table[slot] = -1
        return state

    @property
    def has_recurrent_state(self) -> bool:
        """True when the arch keeps slot-major recurrent/SSM state beside
        the paged KV pools (pages hold only attention KV)."""
        return any(kind in (RECURRENT, SSM)
                   for kind, _ in tfm.layer_plan(self.cfg))

    def set_sampling(self, state: InferenceState, slot: int,
                     params: "sampling.SamplingParams",
                     context=()) -> InferenceState:
        """Install a request's sampling config into ``slot``. The port
        serves greedy requests only; the sampler (``sampling.draw``) waits
        for ROADMAP Queue A, item 5."""
        params.validate()
        if not params.greedy:
            raise NotImplementedError(
                "sampled decoding (temperature > 0) is not ported yet "
                "(ROADMAP Queue A, item 5)")
        return state

    def copy_pages(self, state, src, dst):
        raise NotImplementedError(f"copy-on-write pages (prefix cache) are {_ROADMAP}")

    def get_slot_state(self, state, slot):
        raise NotImplementedError(f"slot snapshots (prefix cache) are {_ROADMAP}")

    def set_slot_state(self, state, slot, rows):
        raise NotImplementedError(f"slot snapshots (prefix cache) are {_ROADMAP}")

    def swap_out(self, state, slot, pages):
        raise NotImplementedError(f"preemption is {_ROADMAP}")

    def swap_in(self, state, slot, pages, blob):
        raise NotImplementedError(f"preemption is {_ROADMAP}")

    def spill_page(self, state, page):
        raise NotImplementedError(f"the host tier is {_ROADMAP}")

    def restore_pages(self, state, pages, blobs):
        raise NotImplementedError(f"the host tier is {_ROADMAP}")

    # -- the steps ---------------------------------------------------------
    def _tokens(self, inputs: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        if set(inputs) != {"tokens"}:
            raise NotImplementedError(
                f"inputs {sorted(inputs)}: only token prompts are ported")
        return {"tokens": torch.as_tensor(np.asarray(inputs["tokens"]),
                                          dtype=torch.int32,
                                          device=self.device)}

    def _flags(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    def insert(self, state: InferenceState, inputs: Dict[str, Any],
               slot: int):
        """Prefill ONE request (tokens (1, L), exact length, so recurrent
        and SSM state is exact) into slot ``slot``, whose page row must
        already be installed (``assign_pages``): KV rings scatter into its
        pages, recurrent/SSM state into its row. Returns (state, first
        greedy token (1,))."""
        inputs = self._tokens(inputs)
        with torch.inference_mode():
            logits, cache_one = tfm.prefill(state.params, self.cfg, inputs,
                                            max_len=self.max_len,
                                            dtype=self.dtype, ops=self.ops)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)      # (1,)
            tfm.scatter_prefill_paged(self.cfg, state.cache, cache_one,
                                      state.page_table[slot], slot)
            state.positions[slot] = inputs["tokens"].shape[1]
            state.last_tok[slot] = tok[0]
        return state, tok.cpu().numpy()

    def insert_chunk(self, state: InferenceState, inputs: Dict[str, Any],
                     slot: int, pos_start: int):
        """Insert ONE prompt chunk (tokens (1, C)) starting at absolute
        position ``pos_start`` into slot ``slot``'s pages and state row.
        Returns (state, greedy token (1,)), meaningful only for a
        prompt's final chunk."""
        inputs = self._tokens(inputs)
        with torch.inference_mode():
            logits, _ = tfm.prefill_chunk(
                state.params, self.cfg, inputs, state.cache,
                state.page_table[slot], slot, int(pos_start),
                dtype=self.dtype, ops=self.ops)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)      # (1,)
            state.positions[slot] = int(pos_start) + inputs["tokens"].shape[1]
            state.last_tok[slot] = tok[0]
        return state, tok.cpu().numpy()

    def decode(self, state: InferenceState, active=None):
        """One decode step over ALL slots: each active slot's last token
        advances its own position counter; inactive slots neither touch
        the page pool nor advance their position or recurrent state.
        Returns (state, greedy tokens
        (slots,)); inactive slots' tokens are garbage the scheduler
        ignores."""
        if active is None:
            active = np.ones((self.slots,), bool)
        act = self._flags(active).bool()
        with torch.inference_mode():
            logits, _ = tfm.decode_step_paged(
                state.params, self.cfg, {"tokens": state.last_tok[:, None]},
                state.cache, state.positions, state.page_table, act,
                dtype=self.dtype, ops=self.ops)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)      # (S,)
            state.positions.add_(act.to(torch.int32))
            state.last_tok.copy_(torch.where(act, tok, state.last_tok))
        return state, tok.cpu().numpy()

    def verify(self, state: InferenceState, drafts, draft_len, active):
        """One fused speculative step over ALL slots: feed each active
        slot its last token plus ``drafts`` (slots, K), verify in ONE paged
        forward, and accept the longest prefix of drafts matching the
        model's own greedy next tokens (drafts past ``draft_len`` never
        match); recurrent/SSM rows roll back to the state at each slot's
        last accepted token (``select_verified``). Returns (state, emitted (slots, K+1), consumed (slots,)):
        slot ``s`` emitted ``emitted[s, :consumed[s]]``, the same tokens
        ``consumed[s]`` successive :meth:`decode` calls would give, and
        advanced its position by ``consumed[s]``."""
        drafts = torch.as_tensor(np.asarray(drafts), dtype=torch.int32,
                                 device=self.device)
        dlen = torch.as_tensor(np.asarray(draft_len), dtype=torch.int32,
                               device=self.device)
        act = self._flags(active).bool()
        S, K = drafts.shape
        with torch.inference_mode():
            toks = torch.cat([state.last_tok[:, None], drafts], dim=1)
            logits, stacked = tfm.verify_step_paged(
                state.params, self.cfg, {"tokens": toks}, state.cache,
                state.positions, state.page_table, act, dtype=self.dtype,
                ops=self.ops)
            target = torch.argmax(logits, dim=-1).to(torch.int32)  # (S, K+1)
            ar = torch.arange(K, device=self.device)[None, :]
            match = (target[:, :-1] == drafts) & (ar < dlen[:, None])
            n = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
            consumed = torch.where(act, n + 1, 0).to(torch.int32)
            select_verified(stacked, state.cache, n, act)
            last = torch.gather(target, 1, n[:, None].long())[:, 0]
            state.positions.add_(consumed)
            state.last_tok.copy_(torch.where(act, last, state.last_tok))
        return state, target.cpu().numpy(), consumed.cpu().numpy()
