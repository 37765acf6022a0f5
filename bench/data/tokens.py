"""Synthetic token batches for LM training: a frozen copy of the port's
``data/tokens.py`` Zipf generator (a test holds it bit-equal), and the
step-indexed stream the benchmark hands the port's ``ShardedLoader``.

Tokens come from a seeded Zipfian unigram mixed with a copy-previous
process, one stream of S+1 tokens a row: ``tokens`` and ``targets`` are
its next-token pairs. Every step draws the same shapes; the seed only
changes which tokens.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def zipf_tokens(rng: np.random.Generator, shape, vocab: int) -> np.ndarray:
    # Zipfian unigram mixed with a repeat-previous process -> learnable
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    flat = rng.choice(vocab, size=int(np.prod(shape)), p=probs)
    toks = flat.reshape(shape)
    # second-order structure: with p=0.3, copy the previous token
    if toks.ndim == 2 and toks.shape[1] > 1:
        copy = rng.random(toks.shape) < 0.3
        copy[:, 0] = False
        shifted = np.roll(toks, 1, axis=1)
        toks = np.where(copy, shifted, toks)
    return toks.astype(np.int32)


def token_batch(vocab: int, batch: int, seq_len: int,
                seed: int) -> Dict[str, np.ndarray]:
    """``{"tokens", "targets"}`` (batch, seq_len) int32 from ``seed``."""
    rng = np.random.default_rng(seed)
    toks = zipf_tokens(rng, (batch, seq_len + 1), vocab)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


class TokenStream:
    """An endless token stream indexed by step (the port's ``DataSource``
    protocol): step ``i`` is ``token_batch`` seeded ``seed + i``."""

    steps_per_epoch = None

    def __init__(self, vocab: int, batch: int, seq_len: int, seed: int):
        self.vocab, self.batch, self.seq_len = vocab, batch, seq_len
        self.seed = seed

    def host_batch(self, step: int) -> Dict[str, np.ndarray]:
        return token_batch(self.vocab, self.batch, self.seq_len,
                           self.seed + step)
