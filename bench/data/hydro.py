"""Synthetic watersheds for Dom-ST training, and the stacked batches the
port's input pipeline cuts from them: frozen copies of the port's
``data/synthetic_hydro.py`` generator and of the window, split, shuffle
and packing arithmetic of its ``data/pipeline.py`` (a test holds each
bit-equal to the port's).

The generator stands in for CRU pixel precipitation and USGS discharge:
spatially correlated storms with seasonal modulation, a meandering stream
per watershed, and discharge routed through per-pixel unit hydrographs
whose lag and attenuation grow with the pixel's distance to the stream.

The benchmark hands the raw watersheds (``generate_watershed``) to the
port, whose pipeline windows and batches them on the timed path;
``stacked_batches`` rebuilds the same batches here, for the reference.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def _stream_mask(h: int, w: int, rng: np.random.Generator) -> np.ndarray:
    """Random meandering stream through the grid; True = channel pixel."""
    mask = np.zeros((h, w), bool)
    col = rng.integers(0, w)
    for row in range(h):
        mask[row, col] = True
        col = int(np.clip(col + rng.integers(-1, 2), 0, w - 1))
        mask[row, col] = True
    return mask


def _distance_to(mask: np.ndarray) -> np.ndarray:
    """Chebyshev distance transform (small grids; O(P * channels))."""
    h, w = mask.shape
    ys, xs = np.nonzero(mask)
    yy, xx = np.mgrid[0:h, 0:w]
    d = np.min(np.maximum(np.abs(yy[..., None] - ys),
                          np.abs(xx[..., None] - xs)), axis=-1)
    return d.astype(np.float32)


def _storm_fields(T: int, h: int, w: int, rng: np.random.Generator,
                  wet_prob: float, intensity: float) -> np.ndarray:
    """Spatially correlated storms: random centers + gaussian footprints,
    advected across days; seasonal (annual sine) modulation."""
    P = h * w
    yy, xx = np.mgrid[0:h, 0:w]
    season = 1.0 + 0.8 * np.sin(2 * np.pi * np.arange(T) / 365.0
                                + rng.uniform(0, 2 * np.pi))
    out = np.zeros((T, h, w), np.float32)
    t = 0
    while t < T:
        if rng.random() < wet_prob:
            dur = int(rng.integers(1, 4))
            cy, cx = rng.uniform(0, h), rng.uniform(0, w)
            vy, vx = rng.normal(0, 1.0, 2)
            sig = rng.uniform(1.5, max(h, w) / 2)
            amp = intensity * rng.lognormal(0.0, 0.7)
            for k in range(dur):
                if t + k >= T:
                    break
                fy, fx = cy + vy * k, cx + vx * k
                foot = np.exp(-(((yy - fy) ** 2 + (xx - fx) ** 2)
                                / (2 * sig ** 2)))
                out[t + k] += amp * season[t + k] * foot.astype(np.float32)
            t += dur
        else:
            t += 1
    out += rng.gamma(0.3, 0.5, (T, h, w)).astype(np.float32) * 0.1  # drizzle
    return out.reshape(T, P)


def generate_watershed(watershed_id: int, *, num_days: int,
                       grid: Tuple[int, int] = (8, 8), seed: int = 0
                       ) -> Dict[str, np.ndarray]:
    """One watershed's ``precip`` (T, P), ``dist`` (P,) and ``discharge``
    (T,), float32, from ``seed`` and its id."""
    rng = np.random.default_rng(seed * 1000 + watershed_id)
    h, w = grid
    P = h * w

    mask = _stream_mask(h, w, rng)
    dist = _distance_to(mask).reshape(P)

    wet_prob = rng.uniform(0.15, 0.45)       # climate varies by watershed
    intensity = rng.uniform(0.5, 2.0)
    precip = _storm_fields(num_days, h, w, rng, wet_prob, intensity)

    # per-pixel routing: lag and attenuation grow with distance-to-stream;
    # near-stream pixels respond the same day (the flash-flood physics)
    runoff_k = rng.uniform(0.3, 1.0, P).astype(np.float32)
    max_lag = 14
    taus = np.arange(1, max_lag + 1, dtype=np.float32)[None, :]  # (1, L)
    peak = (dist[:, None] / 2.0) + 1.0
    kern = (taus / peak) * np.exp(1.0 - taus / peak)             # (P, L)
    kern = kern / np.maximum(kern.sum(1, keepdims=True), 1e-6)
    atten = np.exp(-dist / (0.35 * max(h, w)))
    weight = (runoff_k * atten)[:, None] * kern                  # (P, L)

    T = num_days
    q = np.zeros(T, np.float32)
    for l in range(max_lag):
        shifted = np.zeros((T, P), np.float32)
        shifted[l:] = precip[:T - l]
        q += shifted @ weight[:, l]
    base = rng.uniform(0.5, 2.0)
    q = q + base + rng.normal(0, 0.02 * q.std(), T).astype(np.float32)
    return {"precip": precip, "dist": dist,
            "discharge": q.astype(np.float32)}


def training_windows(ws: Dict[str, np.ndarray], window: int = 30
                     ) -> Dict[str, np.ndarray]:
    """Every supervised window of one watershed, normalised: ``precip``
    (N, T, P), ``target_day`` (N, P), ``dist`` (P,), ``discharge`` (N,)."""
    T, P = ws["precip"].shape
    n = T - window
    idx = np.arange(n)[:, None] + np.arange(window)[None, :]
    precip = ws["precip"][idx]
    target_day = ws["precip"][window:]
    q = ws["discharge"][window:]
    p_std = precip.std() + 1e-6
    q_mean, q_std = float(q.mean()), float(q.std() + 1e-6)
    return {"precip": (precip / p_std).astype(np.float32),
            "target_day": (target_day / p_std).astype(np.float32),
            "dist": (ws["dist"] / (ws["dist"].max() + 1e-6)).astype(
                np.float32),
            "discharge": ((q - q_mean) / q_std).astype(np.float32)}


def train_count(n_windows: int, test_frac: float) -> int:
    """Windows in the leading (training) split."""
    return int(n_windows * (1 - test_frac))


def epoch_order(seed: int, watershed_id: int, epoch: int,
                n: int) -> np.ndarray:
    """The shuffle of a watershed's training windows in an epoch."""
    rng = np.random.default_rng(seed * 997 + watershed_id * 31 + epoch)
    return rng.permutation(n)


def stacked_batches(watersheds: Sequence[Dict[str, np.ndarray]], *,
                    seed: int, steps: Sequence[int], batch: int,
                    test_frac: float, window: int = 30
                    ) -> List[Dict[str, np.ndarray]]:
    """The stacked batch (W, batch, ...) of each global step in ``steps``:
    each watershed's rows of the epoch's shuffle, epochs as long as the
    smallest training split allows whole batches."""
    wins = [training_windows(w, window) for w in watersheds]
    counts = [train_count(len(w["discharge"]), test_frac) for w in wins]
    per_epoch = min(max(1, n // batch) for n in counts)
    out = []
    for step in steps:
        epoch, i = divmod(step, per_epoch)
        parts = []
        for wid, (w, n) in enumerate(zip(wins, counts)):
            rows = epoch_order(seed, wid, epoch, n)[i * batch:(i + 1) * batch]
            parts.append({"precip": w["precip"][rows],
                          "target_day": w["target_day"][rows],
                          "dist": np.broadcast_to(
                              w["dist"], (len(rows), len(w["dist"]))).copy(),
                          "discharge": w["discharge"][rows]})
        out.append({k: np.stack([p[k] for p in parts]) for k in parts[0]})
    return out
