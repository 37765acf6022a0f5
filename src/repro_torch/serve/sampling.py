"""Per-request sampling configuration and the stream digest.

A copy of the host-side part of the reference's ``repro/serve/sampling.py``:
:class:`SamplingParams` (the per-request config the scheduler carries on
each request), ``presence_row`` and ``stream_digest``. The vectorised
sampler ``draw`` is not ported yet (ROADMAP Queue A): the port's engine
serves greedy requests (``temperature <= 0``) and raises for others.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration.

    ``temperature <= 0`` selects the greedy path (raw-logits argmax);
    every other field is then ignored.  ``top_k == 0`` disables top-k;
    ``top_p == 1.0`` disables nucleus filtering; ``rep_penalty == 1.0``
    disables the repetition penalty.  ``seed`` alone determines the
    request's draws."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    rep_penalty: float = 1.0
    seed: int = 0

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0

    def validate(self) -> None:
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.rep_penalty <= 0.0:
            raise ValueError(
                f"rep_penalty must be > 0, got {self.rep_penalty}")


def presence_row(context, vocab: int) -> np.ndarray:
    """Boolean (vocab,) presence of ``context``'s token ids — the initial
    repetition-penalty mask a request's prompt installs at admission."""
    row = np.zeros((vocab,), bool)
    ids = np.asarray(context, np.int64).ravel()
    row[ids[(ids >= 0) & (ids < vocab)]] = True
    return row


def stream_digest(generated) -> str:
    """Order-independent 16-hex digest of a {rid: [token, ...]} result:
    two runs of the same (queue, params, seeds) must print the same
    digest, whatever the arrival order, slot assignment, chunking or
    speculation depth."""
    return hashlib.sha256(json.dumps(
        {str(k): [int(t) for t in generated[k]] for k in sorted(generated)},
        sort_keys=True).encode()).hexdigest()[:16]
