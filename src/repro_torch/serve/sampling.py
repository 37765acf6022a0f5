"""Per-request sampling over the fused serving steps.

The port of the reference's ``repro/serve/sampling.py``:

  * :class:`SamplingParams` — the per-request config (temperature /
    top-k / top-p / repetition penalty / seed) the scheduler carries on
    each request and the engine installs into its per-slot rows at
    admission; ``presence_row`` and ``stream_digest``;
  * :func:`draw` — the vectorised per-slot sampler the engine's steps
    call: one (S, V) logits batch in, one (S,) token batch out, each slot
    under its own parameters.

The key for the token at absolute stream position ``p`` is
``fold_in(base_key(seed), p)``, so a stream is a function of (prompt,
params, seed) alone, whatever the batch, chunking, speculation,
preemption or prefix-cache hit.

The draws are the reference's own, to the bit: the reference keys with
JAX's threefry2x32 PRNG, which :func:`threefry2x32` computes here in
int64 tensor arithmetic masked to 32 bits (torch has no full uint32
arithmetic), on the CPU and on the card alike. It follows the JAX
configuration ``jax_threefry_partitionable=True`` (the default of jax
0.5 and later, and of jax 0.9.0): the 32-bit random word for element
``i`` of a draw is ``x0 ^ x1`` of ``threefry2x32(key, (0, i))``. Under
``jax_threefry_partitionable=False`` (jax 0.4.37's default) JAX lays its
bits out otherwise and the draws differ. Keys are 32-bit seeds as JAX
builds them with 64-bit mode off: ``base_key(seed) = (0, seed mod 2^32)``.
The Gumbel noise is ``-log(-log(u))`` of the uniform in ``[tiny, 1)``
built from the word's top 23 bits, as ``jax.random.gumbel`` in its
default ("low") mode; ``log`` may round differently from XLA's in the
last bit, which can part two draws only at a near tie.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = float(np.finfo(np.float32).tiny)


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
    digest, whatever the arrival order, slot assignment, chunking,
    preemption, speculation depth or prefix-cache tier."""
    return hashlib.sha256(json.dumps(
        {str(k): [int(t) for t in generated[k]] for k in sorted(generated)},
        sort_keys=True).encode()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# threefry2x32 over int64 tensors holding uint32 words
# ---------------------------------------------------------------------------
def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor):
    """The threefry2x32 block cipher (20 rounds), elementwise over
    broadcastable int64 tensors whose values are uint32 words. Returns
    the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for g in range(5):
        for r in _ROTATIONS[g % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & _MASK
        x1 = (x1 + ks[(g + 2) % 3] + (g + 1)) & _MASK
    return x0, x1


def base_key(seed: int) -> np.ndarray:
    """The raw uint32 key words a request's seed expands to — what the
    engine stores in the per-slot ``sample_key`` row; equal to
    ``jax.random.PRNGKey(seed)`` with 64-bit mode off."""
    return np.array([0, int(seed) & _MASK], np.uint32)


def fold_in(keys: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in`` for each row: keys (S, 2) int64 uint32
    words, data (S,) -> (S, 2) folded keys."""
    d = data.to(torch.int64) & _MASK
    y0, y1 = threefry2x32(keys[:, 0], keys[:, 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=1)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(S, n) 32-bit random words of each key, laid out as
    ``jax.random.bits(key, (n,))`` under ``jax_threefry_partitionable``:
    word ``i`` is ``x0 ^ x1`` of ``threefry2x32(key, (0, i))``."""
    i = torch.arange(n, dtype=torch.int64, device=keys.device)[None, :]
    y0, y1 = threefry2x32(keys[:, :1], keys[:, 1:], torch.zeros_like(i), i)
    return y0 ^ y1


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(S, n) float32 Gumbel noise of each key, as ``jax.random.gumbel``
    in its default mode: the uniform in [tiny, 1) from each word's top 23
    bits, then ``-log(-log(u))``."""
    bits = random_bits(keys, n)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    u = torch.clamp_min(f * 1.0 + _TINY, _TINY)
    return -torch.log(-torch.log(u))


def draw(logits: torch.Tensor, *, keys: torch.Tensor,
         positions: torch.Tensor, temperature: torch.Tensor,
         top_k: torch.Tensor, top_p: torch.Tensor,
         rep_penalty: torch.Tensor, presence: torch.Tensor) -> torch.Tensor:
    """Sample one token per slot from ``logits`` (S, V), each slot under
    its own parameters, with the position-folded per-slot key.

    The pipeline (float32 throughout), in the reference's order:
    repetition penalty over ``presence``, temperature, one descending
    sort for the top-k cut and the top-p (nucleus) cut over the surviving
    distribution, then a Gumbel categorical with ``fold_in(keys[s],
    positions[s])``. Ties at the top-k/top-p threshold keep every tied
    token. Callers gate on ``temperature > 0`` — this function always
    samples. Returns (S,) int32."""
    l = logits.float()
    S, V = l.shape
    pen = rep_penalty.float()[:, None]
    l = torch.where(presence & (pen != 1.0),
                    torch.where(l > 0, l / pen, l * pen), l)
    l = l / torch.clamp_min(temperature.float(), 1e-6)[:, None]
    sorted_l = torch.sort(l, dim=-1, descending=True).values
    k = torch.clamp(torch.where(top_k > 0, top_k, V), 1, V).long()
    kth = torch.gather(sorted_l, 1, (k - 1)[:, None])
    neg = torch.tensor(float("-inf"), device=l.device)
    l = torch.where(l < kth, neg, l)
    sorted_l = torch.where(sorted_l < kth, neg, sorted_l)
    probs = torch.softmax(sorted_l, dim=-1)
    csum = torch.cumsum(probs, dim=-1)
    # a sorted token survives when the mass BEFORE it is still short of
    # top_p: the kept set is the smallest prefix reaching the target
    keep = (csum - probs) < top_p.float()[:, None]
    nkeep = torch.clamp_min(keep.sum(dim=-1), 1)
    thr = torch.gather(sorted_l, 1, (nkeep - 1)[:, None])
    l = torch.where(l < thr, neg, l)
    folded = fold_in(keys, positions)
    return torch.argmax(gumbel(folded, V) + l, dim=-1).to(torch.int32)
