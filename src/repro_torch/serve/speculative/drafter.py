"""Drafters: token proposers for speculative decoding over the paged pool.

The port of the reference's ``repro/serve/speculative/drafter.py``. A
drafter guesses the next K tokens of each active request; the engine
checks every guess in ONE fused ``verify`` forward and accepts the
longest prefix matching the target's own next tokens (its argmax, or its
position-keyed draw for a sampled request), so speculation is lossless:
a bad drafter costs speed, never correctness.

Two implementations behind one :class:`Drafter` protocol:

  * :class:`NgramDrafter` — prompt lookup on the host (numpy): propose
    the tokens that followed the most recent earlier occurrence of the
    context's trailing n-gram;
  * :class:`ModelDrafter` — a second model config served greedily by its
    own paged :class:`InferenceEngine` on the same device (or the
    target's mesh, ``mesh=``), slot-aligned
    with the target scheduler's slots; its params from the port's init or
    a checkpoint (:meth:`ModelDrafter.from_checkpoint`).

ModelDrafter sync discipline: the drafter's committed state only ever
consumes CONFIRMED tokens. Each round it (1) teacher-forces the tokens
confirmed since its last round through ``insert_chunk`` — whose final
logits give the first proposal — then (2) rolls the remaining K-1
proposals out by greedy decode steps. The reference rolls out on an
undonated copy of its state and drops it; the port's steps update the
state in place, so the rollout saves the draft slots' positions, last
tokens and recurrent/SSM rows first and writes them back after. KV that
the rollout wrote past the committed position needs no undo: each draft
slot keeps one static page row, the position mask hides those entries,
and the next catch-up or rollout overwrites each one before a query can
reach its position.
"""
from __future__ import annotations

from typing import Dict, Optional, Protocol, Tuple, runtime_checkable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import PagedKVCache
from repro_torch.serve.engine import InferenceEngine

#: propose() input: slot -> (confirmed context tokens, max proposals)
Wants = Dict[int, Tuple[np.ndarray, int]]


@runtime_checkable
class Drafter(Protocol):
    """Host-side proposal policy driven by the scheduler each spec round."""

    def propose(self, wants: Wants) -> Dict[int, np.ndarray]:
        """For each slot, up to ``k`` proposed next tokens (possibly fewer,
        possibly empty).  ``context`` is the request's confirmed stream:
        prompt followed by every token emitted so far."""
        ...

    def release(self, slot: int) -> None:
        """The request in ``slot`` finished; forget any per-slot state
        before the scheduler recycles the slot."""
        ...


class NgramDrafter:
    """Prompt-lookup drafter: propose the continuation of the most recent
    earlier occurrence of the context's trailing n-gram.

    Tries n-gram lengths from ``max_ngram`` down to ``min_ngram`` and
    returns the first hit's following tokens.  The scan is bounded to the
    trailing ``lookback`` tokens so per-step host work stays O(lookback)
    however long a generation runs (losslessness does not depend on WHAT
    is proposed, so bounding the search window is free).  Stateless across
    slots, so :meth:`release` is a no-op."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1,
                 lookback: int = 2048):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(f"need 1 <= min_ngram <= max_ngram, got "
                             f"({min_ngram}, {max_ngram})")
        if lookback <= max_ngram:
            raise ValueError(f"lookback {lookback} must exceed max_ngram")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        self.lookback = lookback

    def _lookup(self, ctx: np.ndarray, k: int) -> Optional[np.ndarray]:
        L = len(ctx)
        for m in range(self.max_ngram, self.min_ngram - 1, -1):
            if L <= m:
                continue
            key = ctx[L - m:]
            win = np.lib.stride_tricks.sliding_window_view(ctx, m)[:L - m]
            hits = np.nonzero((win == key).all(axis=1))[0]
            if not len(hits):
                continue
            j = int(hits[-1])           # most recent earlier occurrence
            cont = ctx[j + m:j + m + k]
            if len(cont):
                return cont
        return None

    def propose(self, wants: Wants) -> Dict[int, np.ndarray]:
        out = {}
        for slot, (ctx, k) in wants.items():
            ctx = np.asarray(ctx, np.int64)[-self.lookback:]
            cont = self._lookup(ctx, k)
            if cont is not None:
                out[slot] = np.asarray(cont, np.int32)
        return out

    def release(self, slot: int) -> None:
        pass


class ModelDrafter:
    """Draft-model proposer: a config served by its own paged engine,
    slot-aligned with the target scheduler's slots.

    The draft engine provisions its page pool fully (one static page row
    per slot, cleared again on slot reuse through ``assign_pages``) and
    restores what its speculative rollout changed (see the module
    docstring)."""

    def __init__(self, cfg: ModelConfig, params=None, *, mesh=None,
                 slots: int = 4, max_len: int = 64, page_size: int = 16,
                 catch_up_chunk: int = 16, dtype=torch.bfloat16,
                 seed: int = 0, device: str | torch.device = "cuda"):
        """``mesh``: the target's mesh, on which the draft engine places
        its own state by the same rules (params from every rank alike)."""
        self.cfg = cfg
        self.chunk = int(catch_up_chunk)
        if self.chunk < 1:
            raise ValueError("catch_up_chunk must be >= 1")
        self.engine = InferenceEngine(cfg, mesh=mesh, slots=slots,
                                      max_len=max_len, dtype=dtype,
                                      paged=True, page_size=page_size,
                                      device=device)
        if params is None:
            params = tfm.init(cfg, torch.Generator(
                device=self.engine.device).manual_seed(seed), dtype=dtype)
        self.state = self.engine.init_state(params)
        self._pos: Dict[int, int] = {}  # slot -> committed tokens consumed
        self._ctx: Dict[int, np.ndarray] = {}  # slot -> committed prefix

    @classmethod
    def from_checkpoint(cls, cfg: ModelConfig, path: str,
                        **kw) -> "ModelDrafter":
        """Params subtree of a TrainState .npz in the reference's layout —
        the same ``restore_params`` hand-off the target engine uses, onto
        the draft engine's placements with ``mesh=``."""
        d = cls(cfg, **kw)
        params = d.engine.restore_params(path, d.state.params)
        d.state = d.state._replace(params=params)
        return d

    @classmethod
    def from_train_state(cls, train_engine, train_state,
                         **kw) -> "ModelDrafter":
        """Adopt a live trained LM state (``train.Engine.for_lm``) on the
        train engine's device or mesh, as ``InferenceEngine.
        from_train_state`` does (no host gather)."""
        return cls(train_engine.cfg, train_engine.params_tree(train_state),
                   mesh=train_engine.mesh, device=train_engine.device, **kw)

    # -- the drafting round ------------------------------------------------
    def _assign(self, slot: int) -> None:
        per = self.engine.pages_per_slot
        self.state = self.engine.assign_pages(
            self.state, slot, list(range(slot * per, (slot + 1) * per)))
        self._pos[slot] = 0

    def _catch_up(self, slot: int, ctx: np.ndarray) -> int:
        """Teacher-force the confirmed tokens this slot's committed state
        has not consumed yet (in bounded chunks); the final chunk's argmax
        is the first proposal.

        The committed prefix is the slot's fingerprint: a context that
        does not extend it (a recycled slot whose ``release`` was missed,
        a drafter shared across schedulers) re-assigns the slot and
        replays from scratch, whatever the lengths say."""
        start = self._pos.get(slot)
        committed = self._ctx.get(slot)
        if start is None or start > len(ctx) - 1 or committed is None \
                or not np.array_equal(committed, ctx[:start]):
            self._assign(slot)          # fresh request in a recycled slot
            start = 0
        tok = None
        while start < len(ctx):
            c = ctx[start:start + self.chunk]
            self.state, tok = self.engine.insert_chunk(
                self.state, {"tokens": np.asarray(c, np.int32)[None]},
                slot, start)
            start += len(c)
        self._pos[slot] = len(ctx)
        self._ctx[slot] = np.array(ctx, np.int32, copy=True)
        return int(np.asarray(tok)[0])

    def _rollout_rows(self) -> list:
        """The tensors a greedy decode step changes outside the page
        pools: positions, last tokens and every recurrent/SSM leaf."""
        st = self.state
        return [st.positions, st.last_tok] + [
            t for entry in st.cache if not isinstance(entry, PagedKVCache)
            for t in entry]

    def propose(self, wants: Wants) -> Dict[int, np.ndarray]:
        drafts = {}
        for slot, (ctx, _k) in wants.items():
            ctx = np.asarray(ctx, np.int32)
            total = len(ctx) + 1        # +1: the proposal being drafted
            if total > self.engine.max_len:
                continue                # request outgrew the draft cache
            drafts[slot] = [self._catch_up(slot, ctx)]
        if not drafts:
            return {}
        kmax = max(k for s, (_c, k) in wants.items() if s in drafts)
        if kmax > 1:
            mask = np.zeros((self.engine.slots,), bool)
            mask[list(drafts)] = True
            # the speculative rollout: committed rows are put back after,
            # so they never hold an unconfirmed token
            saved = [t.clone() for t in self._rollout_rows()]
            for i in range(1, kmax):
                self.state, toks = self.engine.decode(self.state,
                                                      active=mask)
                for slot in drafts:
                    if i < wants[slot][1]:
                        drafts[slot].append(int(toks[slot]))
            with torch.no_grad():
                for t, keep in zip(self._rollout_rows(), saved):
                    t.copy_(keep)
        return {s: np.asarray(d[:wants[s][1]], np.int32)
                for s, d in drafts.items()}

    def release(self, slot: int) -> None:
        self._pos.pop(slot, None)
        self._ctx.pop(slot, None)
