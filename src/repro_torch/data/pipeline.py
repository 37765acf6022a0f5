"""Input pipeline, the part the Dom-ST forecast needs.

Builds supervised windows per watershed and normalizes features; the
held-out tail of every watershed, stacked on a leading watershed axis, is
what the ``Forecaster`` rolls forward. These are copies of the reference's
``data/pipeline.py`` functions and give the same arrays, bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.data.synthetic_hydro import WatershedData


@dataclass
class WatershedWindows:
    """Supervised windows for one watershed."""
    watershed_id: int
    precip: np.ndarray      # (N, T, P) trailing window of pixel precipitation
    target_day: np.ndarray  # (N, P) target day's precipitation (the +P input)
    dist: np.ndarray        # (P,) domain prior (static per watershed)
    discharge: np.ndarray   # (N,) label
    q_mean: float
    q_std: float


def make_domst_windows(num_watersheds: int, days: int
                       ) -> List[WatershedWindows]:
    """The deterministic synthetic watershed window set: the same
    ``(num_watersheds, days)`` always gives the same windows, so a forecast
    is scored against exactly the split training evaluated."""
    from repro_torch.data.synthetic_hydro import generate_all_watersheds
    data = generate_all_watersheds(num_watersheds, num_days=days)
    return [make_training_windows(w) for w in data.values()]


def make_training_windows(ws: WatershedData, window: int = 30
                          ) -> WatershedWindows:
    T, P = ws.precip.shape
    n = T - window
    idx = np.arange(n)[:, None] + np.arange(window)[None, :]
    precip = ws.precip[idx]                                     # (N, T, P)
    target_day = ws.precip[window:]                             # day being predicted
    q = ws.discharge[window:]
    p_std = precip.std() + 1e-6
    q_mean, q_std = float(q.mean()), float(q.std() + 1e-6)
    return WatershedWindows(
        watershed_id=ws.watershed_id,
        precip=(precip / p_std).astype(np.float32),
        target_day=(target_day / p_std).astype(np.float32),
        dist=(ws.dist / (ws.dist.max() + 1e-6)).astype(np.float32),
        discharge=((q - q_mean) / q_std).astype(np.float32),
        q_mean=q_mean, q_std=q_std,
    )


def _pack(w: WatershedWindows, sl) -> Dict[str, np.ndarray]:
    """The batch dict for an index array / slice into ``w``'s windows."""
    n = len(w.discharge[sl])
    return {
        "precip": w.precip[sl],
        "target_day": w.target_day[sl],
        "dist": np.broadcast_to(w.dist, (n, len(w.dist))).copy(),
        "discharge": w.discharge[sl],
    }


def train_test_split(w: WatershedWindows, test_frac: float = 0.2
                     ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    n = len(w.discharge)
    cut = int(n * (1 - test_frac))
    return _pack(w, slice(0, cut)), _pack(w, slice(cut, n))


def stacked_test_batch(windows: Sequence[WatershedWindows],
                       test_frac: float = 0.2) -> Dict[str, np.ndarray]:
    """Held-out batch with a leading watershed axis (W, N_test, ...); all
    watersheds share a window count."""
    parts = [train_test_split(w, test_frac)[1] for w in windows]
    return {k: np.stack([p[k] for p in parts]) for k in parts[0]}
