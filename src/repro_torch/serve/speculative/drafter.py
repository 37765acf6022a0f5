"""Drafters: token proposers for speculative decoding over the paged pool.

A copy of the reference's ``repro/serve/speculative/drafter.py``, its
:class:`Drafter` protocol and :class:`NgramDrafter` (host code, numpy).
A drafter guesses the next K tokens of each active request; the engine
checks every guess in ONE fused ``verify`` forward and accepts the
longest greedy-matching prefix, so speculation is lossless: a bad
drafter costs speed, never correctness. The reference's ``ModelDrafter``
(a second, smaller model on its own engine) is not ported yet (ROADMAP
Queue A).
"""
from __future__ import annotations

from typing import Dict, Optional, Protocol, Tuple, runtime_checkable

import numpy as np

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
