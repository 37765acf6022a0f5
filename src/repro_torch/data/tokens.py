"""Synthetic token, frame and patch batches for LM training: a copy of
the reference's ``data/tokens.py`` (numpy only), held bit-equal to it by
the tests.

Token streams come from a seeded Zipfian n-gram process (so loss actually
decreases during smoke training, unlike uniform noise).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.configs.base import ModelConfig


def _zipf_tokens(rng: np.random.Generator, shape, vocab: int) -> np.ndarray:
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


def synthetic_token_batch(cfg: ModelConfig, batch: int, seq_len: int,
                          seed: int = 0) -> Dict[str, np.ndarray]:
    """The batch of cfg's family, drawn in the reference's order. Tokens:
    ``{"tokens", "targets"}`` (B, S) int32, the next-token pairs of one
    Zipfian stream of S+1 tokens a row. Audio: ``frames`` (B, S, Fd)
    float32 N(0, 1), unit ``targets`` and a HuBERT-style ``loss_mask``
    over ~8% of the frames. VLM: ``patches`` (B, P, Fd) float32 N(0, 1)
    and the token pairs of the S - P text positions."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        frames = rng.normal(0, 1, (batch, seq_len, cfg.frontend_dim))
        targets = _zipf_tokens(rng, (batch, seq_len), cfg.vocab_size)
        # HuBERT-style mask: ~8% spans masked; loss only on masked frames
        mask = (rng.random((batch, seq_len)) < 0.08).astype(np.float32)
        return {"frames": frames.astype(np.float32), "targets": targets,
                "loss_mask": mask}
    if cfg.family == "vlm":
        p = cfg.num_patches
        text_len = seq_len - p
        toks = _zipf_tokens(rng, (batch, text_len + 1), cfg.vocab_size)
        patches = rng.normal(0, 1, (batch, p, cfg.frontend_dim))
        return {"patches": patches.astype(np.float32),
                "tokens": toks[:, :-1],
                "targets": toks[:, 1:]}
    toks = _zipf_tokens(rng, (batch, seq_len + 1), cfg.vocab_size)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


class TokenSource:
    """Endless synthetic token stream as a ``DataSource`` for the
    ShardedLoader: the batch at global step ``i`` is seeded ``seed + i``,
    so the step counter is the resumable stream cursor (restoring a
    checkpoint at step N and restarting the source there replays exactly
    the continuation an uninterrupted run would have produced)."""

    steps_per_epoch = None

    def __init__(self, cfg: ModelConfig, batch_size: int, seq_len: int, *,
                 seed: int = 0):
        self.cfg = cfg
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.seed = seed

    def host_batch(self, step: int) -> Dict[str, np.ndarray]:
        return synthetic_token_batch(self.cfg, self.batch_size, self.seq_len,
                                     seed=self.seed + step)
