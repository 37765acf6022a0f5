"""The paged inference engine: prefill-insert, chunked insert, fused
all-slot decode and speculative verify over request slots, on one device.

The port of ``repro/serve/engine.py::InferenceEngine`` in paged mode. It
exposes the surface the scheduler (``serve/scheduler.py``, a copy of the
reference's) calls:

  * attributes ``paged``, ``page_size``, ``num_pages``, ``pages_per_slot``,
    ``slots``, ``max_len``, ``prefill_chunk``, ``has_recurrent_state``;
  * ``assign_pages`` / ``release_pages`` (page-table installs), and the
    policy hooks of the prefix cache (``copy_pages`` for copy-on-write,
    ``get/set_slot_state`` for recurrent snapshots at page boundaries),
    of preemption (``swap_out`` / ``swap_in``) and of the host tier
    (``spill_page`` / ``restore_pages``), whose blobs keep the
    reference's layout (``serve/state.py``);
  * ``set_sampling``: a request's sampling rows (``serve/sampling.py``);
  * ``insert`` (whole-prompt prefill at the exact prompt length, a VLM's
    image patches before the prompt, its ring cache scattered into the
    slot's pages and its recurrent/SSM state into the slot's row),
    ``insert_chunk`` (one prompt chunk written through
    the slot's page row and state row), ``decode`` (one token for every
    slot, ``active`` gating every write) and ``verify`` (one forward over
    each slot's last token plus K drafts, acceptance of the longest prefix
    matching the model's own next tokens, recurrent rows rolled back to
    the last accepted token).

Each step emits the argmax for a greedy slot and a draw under the slot's
own key, folded by absolute stream position, for a sampled one. The
sampler runs only when some slot samples (the host copy of the
temperatures says so): an all-greedy batch is the bare argmax.

The reference's steps are jitted and donated; the port runs them eagerly
under ``torch.inference_mode`` and updates the state's tensors in place,
so a hook that restores rows writes into the existing tensors. Token
outputs come back as numpy arrays, which is where a step waits for the
device. ``from_train_state`` adopts a live LM training state. The
contiguous (unpaged) layout is not ported: ``paged`` is always True.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``); without a card they raise. ``ops=transformer.PLAIN``
serves only to hold the kernels' run against their plain versions on the
card.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint import restore_lm_params
from repro_torch.configs.base import RECURRENT, SSM, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.obs import profiler
from repro_torch.serve import sampling
from repro_torch.serve.state import (
    InferenceState, cache_leaves, clear_pages, concat_page_rows,
    copy_pool_pages, gather_page_rows, gather_slot_rows,
    new_paged_inference_state, scatter_page_rows, scatter_slot_rows,
    select_verified,
)


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
        self._leaves = cache_leaves(cfg)

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

    @classmethod
    def from_train_state(cls, train_engine, train_state, *, slots: int = 4,
                         max_len: int = 64, dtype: torch.dtype = torch.bfloat16,
                         **kw) -> tuple["InferenceEngine", InferenceState]:
        """Adopt a trained state of an LM ``train.Engine`` (``for_lm``) on
        its device: its flat params as the per-layer tree, without the
        replica axis, cast to the serving ``dtype`` (a float32 leaf is
        shared, not copied). The train state must not be stepped
        afterwards: the serving state may share its tensors."""
        eng = cls(train_engine.cfg, slots=slots, max_len=max_len,
                  dtype=dtype, device=train_engine.device, **kw)
        return eng, eng.init_state(train_engine.params_tree(train_state))

    def restore_params(self, path: str, example_params: Any) -> Any:
        """The ``params`` subtree of a TrainState .npz in the reference's
        layout (its key paths: ``params/blocks/<i>/attn/wq`` stacked over
        the repetitions, ``params/prefix/<j>/...``), restored into
        ``example_params``' layers, shapes, dtypes and device — the CLI
        hand-off without touching optimizer moments."""
        return restore_lm_params(path, example_params, prefix="params")

    def assign_pages(self, state: InferenceState, slot: int, pages,
                     fresh=None) -> InferenceState:
        """Install ``pages`` (ordered physical page ids from the
        scheduler's free list) as ``slot``'s page row, and reset the
        position metadata of the FRESH ones (default: all of ``pages``) in
        every layer pool: a page recycled from an evicted request must
        never leak stale entries into its new owner's attention mask. A
        prefix-cache admission passes only its newly claimed pages, so the
        shared run's cached entries survive the install."""
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
        the paged KV pools (pages hold only attention KV), so a prefix
        hit resumes from a recurrent snapshot at a page boundary."""
        return any(kind in (RECURRENT, SSM)
                   for kind, _ in tfm.layer_plan(self.cfg))

    # -- policy hooks: prefix cache, preemption, host tier ------------------
    def copy_pages(self, state: InferenceState, src, dst) -> InferenceState:
        """Copy-on-write: clone pool pages ``src`` into ``dst`` in every
        page pool (k, v and pos). The scheduler calls this when an
        admission must write into a page it shares: the write lands in the
        private copy and the shared original stays as its readers saw it."""
        with torch.inference_mode():
            copy_pool_pages(state.cache, src, dst)
        return state

    def get_slot_state(self, state: InferenceState, slot: int) -> list:
        """Host snapshot of ``slot``'s recurrent/SSM rows (leaf-aligned,
        ``None`` per paged leaf) — what the prefix cache stores per
        registered page boundary so a later hit can resume mid-prompt."""
        return gather_slot_rows(state.cache, self._leaves, slot)

    def set_slot_state(self, state: InferenceState, slot: int,
                       rows: list) -> InferenceState:
        """Restore a ``get_slot_state`` snapshot into ``slot`` (any slot),
        in place."""
        with torch.inference_mode():
            scatter_slot_rows(state.cache, self._leaves, slot, rows)
        return state

    def _install_sampling(self, state: InferenceState, slot: int,
                          temp: float, top_k: int, top_p: float, rep: float,
                          key, presence) -> InferenceState:
        """Write one slot's sampling rows (shared by ``set_sampling`` and
        ``swap_in``), in place, and its host temperature."""
        key = np.asarray(key, np.uint32).astype(np.int64)
        with torch.inference_mode():
            state.sample_temp[slot] = float(temp)
            state.sample_top_k[slot] = int(top_k)
            state.sample_top_p[slot] = float(top_p)
            state.sample_rep[slot] = float(rep)
            state.sample_key[slot] = torch.from_numpy(key).to(self.device)
            state.tok_presence[slot] = torch.from_numpy(
                np.asarray(presence, bool)).to(self.device)
        state.temp_host[slot] = temp
        return state

    def set_sampling(self, state: InferenceState, slot: int,
                     params: "sampling.SamplingParams",
                     context=()) -> InferenceState:
        """Install a request's :class:`~repro_torch.serve.sampling.
        SamplingParams` into ``slot``'s rows at admission: parameters, the
        seed's base key, and the repetition-penalty presence row seeded
        with ``context`` (the full prompt — also on a prefix-cache resume,
        so the mask never depends on the resume offset)."""
        params.validate()
        return self._install_sampling(
            state, int(slot), params.temperature, params.top_k,
            params.top_p, params.rep_penalty,
            sampling.base_key(params.seed),
            sampling.presence_row(context, self.cfg.padded_vocab()))

    def swap_out(self, state: InferenceState, slot: int, pages) -> dict:
        """Page-aware preemption, out half: host copies of JUST the
        victim's pool rows (every paged leaf at ``pages``), its slot-major
        recurrent rows, counters and sampling rows. With the host-side
        request (prompt + generated tokens) the blob is the complete
        resume state; the pages and the slot can go to another request at
        once."""
        slot = int(slot)
        return {
            "kv": gather_page_rows(state.cache, self._leaves, pages),
            "rec": gather_slot_rows(state.cache, self._leaves, slot),
            "pos": int(state.positions[slot]),
            "last_tok": int(state.last_tok[slot]),
            # the base key and the restored position counter reproduce the
            # folds, so a restored request draws the stream it left
            "samp": {
                "temp": float(state.temp_host[slot]),
                "top_k": int(state.sample_top_k[slot]),
                "top_p": float(state.sample_top_p[slot]),
                "rep": float(state.sample_rep[slot]),
                "key": state.sample_key[slot].cpu().numpy().astype(np.uint32),
                "presence": state.tok_presence[slot].cpu().numpy(),
            },
        }

    def swap_in(self, state: InferenceState, slot: int, pages,
                blob: dict) -> InferenceState:
        """Restore a ``swap_out`` blob into ``slot`` over freshly claimed
        ``pages`` (same count and order as at swap-out; the physical ids
        may differ — page contents are keyed by absolute position). The
        victim resumes decoding exactly where it was preempted."""
        with profiler.annotate("serve.swap_in"):
            state = self.assign_pages(state, slot, pages)
            with torch.inference_mode():
                scatter_page_rows(state.cache, self._leaves, pages,
                                  blob["kv"])
                scatter_slot_rows(state.cache, self._leaves, slot,
                                  blob["rec"])
                state.positions[slot] = int(blob["pos"])
                state.last_tok[slot] = int(blob["last_tok"])
            samp = blob["samp"]
            return self._install_sampling(
                state, int(slot), samp["temp"], samp["top_k"],
                samp["top_p"], samp["rep"], samp["key"], samp["presence"])

    def spill_page(self, state: InferenceState, page: int) -> list:
        """Host copy of ONE pool page across every paged leaf — what the
        prefix cache's host tier keeps when it reclaims a cached page
        under pool pressure. The pos leaf travels in the blob, so the
        content stays keyed by absolute stream positions."""
        return gather_page_rows(state.cache, self._leaves, [int(page)])

    def restore_pages(self, state: InferenceState, pages,
                      blobs: list) -> InferenceState:
        """Scatter per-page spill blobs (one :meth:`spill_page` blob per
        entry of ``pages``, in order) back into freshly claimed pool
        pages, in one host-to-device copy a leaf: a host-tier hit brings
        the KV back instead of prefilling it again."""
        with profiler.annotate("serve.restore_pages"), torch.inference_mode():
            scatter_page_rows(state.cache, self._leaves, pages,
                              concat_page_rows(self._leaves, blobs))
        return state

    # -- the steps ---------------------------------------------------------
    def _inputs(self, inputs: Dict[str, Any],
                patches: bool = True) -> Dict[str, torch.Tensor]:
        """A request's inputs on the device: ``tokens`` int32, and (with
        ``patches``, the vision stub's whole-prompt insert) ``patches``
        float32, which ``embed_inputs`` casts to the activation dtype."""
        allowed = {"tokens", "patches"} if patches else {"tokens"}
        if "tokens" not in inputs or set(inputs) - allowed:
            raise ValueError(f"inputs {sorted(inputs)}: this step takes "
                             f"{sorted(allowed)}")
        out = {"tokens": torch.as_tensor(np.asarray(inputs["tokens"]),
                                         dtype=torch.int32,
                                         device=self.device)}
        if "patches" in inputs:
            out["patches"] = torch.as_tensor(
                np.asarray(inputs["patches"]), dtype=torch.float32,
                device=self.device)
        return out

    def _flags(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    def _draw(self, state: InferenceState, logits: torch.Tensor, rows,
              positions: torch.Tensor, presence: torch.Tensor):
        return sampling.draw(
            logits, keys=state.sample_key[rows], positions=positions,
            temperature=state.sample_temp[rows],
            top_k=state.sample_top_k[rows], top_p=state.sample_top_p[rows],
            rep_penalty=state.sample_rep[rows], presence=presence)

    def _sample_one(self, state: InferenceState, logits: torch.Tensor,
                    slot: int, pos: int) -> torch.Tensor:
        """First-token emission for one slot (prefill, or a prompt's final
        chunk): the argmax when the slot is greedy, else a draw at
        absolute stream position ``pos``. No presence fold: the prompt's
        was installed at admission, and the emitted token folds in at the
        step that consumes it."""
        if state.temp_host[slot] <= 0:
            return torch.argmax(logits, dim=-1).to(torch.int32)  # (1,)
        rows = slice(slot, slot + 1)
        return self._draw(state, logits, rows,
                          torch.full((1,), int(pos), dtype=torch.int32,
                                     device=self.device),
                          state.tok_presence[rows])

    def _sample_all(self, state: InferenceState, logits: torch.Tensor,
                    active: torch.Tensor) -> torch.Tensor:
        """All-slot emission of the fused decode. With every slot greedy
        it is the bare argmax; otherwise each active slot first folds the
        token it just consumed (``last_tok``) into its presence row, then
        draws at position ``positions + 1`` — greedy slots still take the
        raw argmax."""
        greedy = torch.argmax(logits, dim=-1).to(torch.int32)    # (S,)
        if not (state.temp_host > 0).any():
            return greedy
        rows = torch.arange(self.slots, device=self.device)
        pres = state.tok_presence.clone()
        pres[rows, state.last_tok.long()] = True
        pres = torch.where(active[:, None], pres, state.tok_presence)
        toks = self._draw(state, logits, rows, state.positions + 1, pres)
        state.tok_presence.copy_(pres)
        return torch.where(state.sample_temp > 0, toks, greedy)

    def insert(self, state: InferenceState, inputs: Dict[str, Any],
               slot: int):
        """Prefill ONE request (tokens (1, L), exact length, so recurrent
        and SSM state is exact; a VLM's ``patches`` (1, P, Fd) before
        them) into slot ``slot``, whose page row must already be installed
        (``assign_pages``): KV rings scatter into its pages, recurrent/SSM
        state into its row; the slot's position is then P + L, and the
        first token is drawn there. Returns (state, first token (1,))."""
        inputs = self._inputs(inputs)
        with profiler.annotate("serve.insert"), torch.inference_mode():
            logits, cache_one = tfm.prefill(state.params, self.cfg, inputs,
                                            max_len=self.max_len,
                                            dtype=self.dtype, ops=self.ops)
            total = inputs["tokens"].shape[1] + (
                inputs["patches"].shape[1] if "patches" in inputs else 0)
            tok = self._sample_one(state, logits, slot, total)
            tfm.scatter_prefill_paged(self.cfg, state.cache, cache_one,
                                      state.page_table[slot], slot)
            state.positions[slot] = total
            state.last_tok[slot] = tok[0]
        return state, tok.cpu().numpy()

    def insert_chunk(self, state: InferenceState, inputs: Dict[str, Any],
                     slot: int, pos_start: int):
        """Insert ONE prompt chunk (tokens (1, C); never patches: the
        scheduler admits a request with patches whole) starting at absolute
        position ``pos_start`` into slot ``slot``'s pages and state row.
        Returns (state, token (1,)), meaningful only for a prompt's final
        chunk, where ``pos_start + C`` is the position a whole-prompt
        insert would draw at: the draw does not depend on chunking."""
        inputs = self._inputs(inputs, patches=False)
        with profiler.annotate("serve.insert_chunk"), torch.inference_mode():
            logits, _ = tfm.prefill_chunk(
                state.params, self.cfg, inputs, state.cache,
                state.page_table[slot], slot, int(pos_start),
                dtype=self.dtype, ops=self.ops)
            end = int(pos_start) + inputs["tokens"].shape[1]
            tok = self._sample_one(state, logits, slot, end)
            state.positions[slot] = end
            state.last_tok[slot] = tok[0]
        return state, tok.cpu().numpy()

    def decode(self, state: InferenceState, active=None):
        """One decode step over ALL slots: each active slot's last token
        advances its own position counter; inactive slots neither touch
        the page pool nor advance their position, recurrent state or
        presence. Returns (state, tokens (slots,)); inactive slots' tokens
        are garbage the scheduler ignores."""
        if active is None:
            active = np.ones((self.slots,), bool)
        act = self._flags(active).bool()
        with profiler.annotate("serve.decode"), torch.inference_mode():
            logits, _ = tfm.decode_step_paged(
                state.params, self.cfg, {"tokens": state.last_tok[:, None]},
                state.cache, state.positions, state.page_table, act,
                dtype=self.dtype, ops=self.ops)
            tok = self._sample_all(state, logits, act)
            state.positions.add_(act.to(torch.int32))
            state.last_tok.copy_(torch.where(act, tok, state.last_tok))
        return state, tok.cpu().numpy()

    def _sampled_targets(self, state: InferenceState, logits, toks,
                         greedy) -> torch.Tensor:
        """Verify's targets where some slot samples: walk the K+1
        positions in order, folding each INPUT token into presence before
        drawing its successor with that position's key — what K+1
        successive decode steps would draw, which keeps sampled
        speculation exact."""
        rows = torch.arange(self.slots, device=self.device)
        pres = state.tok_presence.clone()
        cols = []
        for i in range(toks.shape[1]):
            pres[rows, toks[:, i].long()] = True
            t = self._draw(state, logits[:, i], rows,
                           state.positions + i + 1, pres)
            cols.append(torch.where(state.sample_temp > 0, t, greedy[:, i]))
        return torch.stack(cols, dim=1)

    def _commit_presence(self, state: InferenceState, toks, consumed,
                         act) -> None:
        """Fold exactly the inputs a verify step consumed into presence:
        the rejected tail must not reach the repetition mask."""
        rows = torch.arange(self.slots, device=self.device)
        pres = state.tok_presence.clone()
        for j in range(toks.shape[1]):
            upd = pres.clone()
            upd[rows, toks[:, j].long()] = True
            pres = torch.where(((j < consumed) & act)[:, None], upd, pres)
        state.tok_presence.copy_(pres)

    def verify(self, state: InferenceState, drafts, draft_len, active):
        """One fused speculative step over ALL slots: feed each active
        slot its last token plus ``drafts`` (slots, K), verify in ONE paged
        forward, and accept the longest prefix of drafts matching the
        model's own next tokens — the argmax for a greedy slot, a draw at
        that position's key for a sampled one (drafts past ``draft_len``
        never match); recurrent/SSM rows roll back to the state at each
        slot's last accepted token (``select_verified``). Returns (state,
        emitted (slots, K+1), consumed (slots,)): slot ``s`` emitted
        ``emitted[s, :consumed[s]]``, the same tokens ``consumed[s]``
        successive :meth:`decode` calls would give, and advanced its
        position by ``consumed[s]``."""
        drafts = torch.as_tensor(np.asarray(drafts), dtype=torch.int32,
                                 device=self.device)
        dlen = torch.as_tensor(np.asarray(draft_len), dtype=torch.int32,
                               device=self.device)
        act = self._flags(active).bool()
        S, K = drafts.shape
        sampled = bool((state.temp_host > 0).any())
        with profiler.annotate("serve.verify"), torch.inference_mode():
            toks = torch.cat([state.last_tok[:, None], drafts], dim=1)
            logits, stacked = tfm.verify_step_paged(
                state.params, self.cfg, {"tokens": toks}, state.cache,
                state.positions, state.page_table, act, dtype=self.dtype,
                ops=self.ops)
            target = torch.argmax(logits, dim=-1).to(torch.int32)  # (S, K+1)
            if sampled:
                target = self._sampled_targets(state, logits, toks, target)
            ar = torch.arange(K, device=self.device)[None, :]
            match = (target[:, :-1] == drafts) & (ar < dlen[:, None])
            n = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
            consumed = torch.where(act, n + 1, 0).to(torch.int32)
            select_verified(stacked, state.cache, n, act)
            if sampled:
                self._commit_presence(state, toks, consumed, act)
            last = torch.gather(target, 1, n[:, None].long())[:, 0]
            state.positions.add_(consumed)
            state.last_tok.copy_(torch.where(act, last, state.last_tok))
        return state, target.cpu().numpy(), consumed.cpu().numpy()
