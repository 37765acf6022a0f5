"""Synthetic 23-watershed hydrology dataset (the paper's data gate).

The paper trains on CRU pixellated daily precipitation + USGS discharge for
23 Iowa watersheds — data we cannot ship.  This generator replaces it with
a *physically structured* simulator so that (a) NSE is a meaningful metric,
(b) the Pix-Con hypothesis is testable: each pixel's contribution to outlet
discharge genuinely depends on its distance to the nearest water source.

Per watershed w (seeded, so the 23 watersheds differ in climate and
geomorphology, as in the paper §2):

  precip[t, p]   spatially correlated lognormal storm fields with seasonal
                 modulation and storm advection,
  dist[p]        distance of pixel p to the nearest stream channel,
  discharge[t] = sum_p k_p * sum_tau g(tau; d_p) * precip[t - tau, p]
                 + baseflow + noise

where the unit-hydrograph kernel g has per-pixel lag/attenuation growing
with dist[p] (near-stream pixels respond fast and strongly -> exactly the
domain knowledge Pix-Con is supposed to recover), and k_p is a soil/land
-cover runoff coefficient.  Flash floods are driven by same-day precipitation
— the paper's motivation for the (+P) target-day input.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np


@dataclass
class WatershedData:
    watershed_id: int
    precip: np.ndarray        # (T, P) daily precipitation per pixel
    dist: np.ndarray          # (P,) distance of pixel to nearest water source
    discharge: np.ndarray     # (T,) outlet discharge
    grid_hw: Tuple[int, int]  # pixel grid shape (h, w), P = h*w


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


def generate_watershed(watershed_id: int, *, num_days: int = 1460,
                       grid: Tuple[int, int] = (8, 8),
                       seed: int = 0) -> WatershedData:
    """One watershed with its own climate/geomorphology (seeded)."""
    rng = np.random.default_rng(seed * 1000 + watershed_id)
    h, w = grid
    P = h * w

    mask = _stream_mask(h, w, rng)
    dist = _distance_to(mask).reshape(P)

    wet_prob = rng.uniform(0.15, 0.45)       # climate varies by watershed
    intensity = rng.uniform(0.5, 2.0)
    precip = _storm_fields(num_days, h, w, rng, wet_prob, intensity)

    # Per-pixel routing: lag and attenuation grow with distance-to-stream.
    runoff_k = rng.uniform(0.3, 1.0, P).astype(np.float32)      # soil/landcover
    max_lag = 14
    # unit hydrograph per pixel: gamma-like kernel peaking at lag ~ dist/2.
    # Near-stream pixels respond the SAME DAY (tau=0) — the paper's
    # flash-flood physics ("the target day's precipitation [is] the primary
    # contributing factor of flash floods"): kern(tau) uses tau+1 so
    # dist=0 pixels peak at tau=0.
    taus = np.arange(1, max_lag + 1, dtype=np.float32)[None, :]  # (1, L)
    peak = (dist[:, None] / 2.0) + 1.0
    kern = (taus / peak) * np.exp(1.0 - taus / peak)             # (P, L), peak=1
    kern = kern / np.maximum(kern.sum(1, keepdims=True), 1e-6)
    atten = np.exp(-dist / (0.35 * max(h, w)))                   # near-stream dominates
    weight = (runoff_k * atten)[:, None] * kern                  # (P, L)

    # discharge[t] = sum_p sum_l weight[p,l] * precip[t-l, p]
    T = num_days
    q = np.zeros(T, np.float32)
    for l in range(max_lag):
        shifted = np.zeros((T, P), np.float32)
        shifted[l:] = precip[:T - l]
        q += shifted @ weight[:, l]
    base = rng.uniform(0.5, 2.0)
    q = q + base + rng.normal(0, 0.02 * q.std(), T).astype(np.float32)

    return WatershedData(watershed_id=watershed_id, precip=precip,
                         dist=dist, discharge=q.astype(np.float32),
                         grid_hw=grid)


def generate_all_watersheds(n: int = 23, **kw) -> Dict[int, WatershedData]:
    """The paper's 23-watershed dataset."""
    return {i: generate_watershed(i, **kw) for i in range(n)}
