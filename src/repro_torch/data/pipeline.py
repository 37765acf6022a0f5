"""Input pipeline (the paper's I.P., Fig. 2a).

Builds supervised windows per watershed and normalizes features; the
held-out tail of every watershed, stacked on a leading watershed axis, is
what ``Engine.eval_step`` scores and the ``Forecaster`` rolls forward.
Training reads the leading split (``train_split``) through
``InputPipeline``: per-(seed, watershed, epoch) shuffles, one watershed at
a time (sequential) or all of them stacked on a leading axis so one step
updates every watershed's replica (``stacked_batches``, the paper's IP-D),
and their step-indexed twins ``WatershedSource`` and ``StackedSource``,
which ``data/loader.py`` reads. These are copies of the reference's
``data/pipeline.py`` (numpy only) and give the same arrays, bit for bit.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Iterator, List, Sequence, Tuple

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


def train_split(w: WatershedWindows, test_frac: float = 0.2
                ) -> WatershedWindows:
    """The first (1 - test_frac) of ``w``'s windows as a WatershedWindows,
    so the tail that ``train_test_split``/``stacked_test_batch`` report on
    stays held out (normalizers and the static dist prior are shared)."""
    cut = int(len(w.discharge) * (1 - test_frac))
    return dataclasses.replace(w, precip=w.precip[:cut],
                               target_day=w.target_day[:cut],
                               discharge=w.discharge[:cut])


def stacked_test_batch(windows: Sequence[WatershedWindows],
                       test_frac: float = 0.2) -> Dict[str, np.ndarray]:
    """Held-out batch with a leading watershed axis (W, N_test, ...); all
    watersheds share a window count."""
    parts = [train_test_split(w, test_frac)[1] for w in windows]
    return {k: np.stack([p[k] for p in parts]) for k in parts[0]}


class InputPipeline:
    """Shards watersheds to nodes and yields (mini)batches.

    Modes (paper Table 1):
      * sequential — iterate watersheds one at a time (the 'S' rows);
      * sharded    — this node only sees ``shard(node, n_nodes)``;
      * stacked    — all local watersheds stacked on a leading axis so one
        vectorized train step updates every watershed's replica at once
        (IP-D).
    """

    def __init__(self, windows: Sequence[WatershedWindows], *,
                 batch_size: int = 64, seed: int = 0):
        self.windows = list(windows)
        self.batch_size = batch_size
        self.seed = seed

    def shard(self, node: int, n_nodes: int) -> "InputPipeline":
        return InputPipeline(self.windows[node::n_nodes],
                             batch_size=self.batch_size, seed=self.seed)

    def num_batches(self, n: int) -> int:
        return max(1, n // self.batch_size)

    def epoch_order(self, w: WatershedWindows, epoch: int) -> np.ndarray:
        """The deterministic shuffle for (seed, watershed, epoch), shared by
        ``batches`` and the step-indexed sources."""
        rng = np.random.default_rng(self.seed * 997 + w.watershed_id * 31 + epoch)
        return rng.permutation(len(w.discharge))

    def batches(self, w: WatershedWindows, epoch: int
                ) -> Iterator[Dict[str, np.ndarray]]:
        """Shuffled minibatches for one watershed."""
        order = self.epoch_order(w, epoch)
        for i in range(self.num_batches(len(w.discharge))):
            yield _pack(w, order[i * self.batch_size:(i + 1) * self.batch_size])

    def steps_per_epoch(self) -> int:
        """Stacked steps per epoch (bounded by the smallest watershed)."""
        return min(self.num_batches(len(w.discharge)) for w in self.windows)

    def stacked_batches(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        """One batch per step with a leading watershed axis (W, B, ...)."""
        its = [self.batches(w, epoch) for w in self.windows]
        for _ in range(self.steps_per_epoch()):
            parts = [next(it) for it in its]
            yield {k: np.stack([p[k] for p in parts]) for k in parts[0]}


class WatershedSource:
    """One watershed's shuffled minibatch stream as a ``DataSource``.

    ``host_batch(step)`` is batch ``step % steps_per_epoch`` of the epoch
    ``step // steps_per_epoch`` permutation: the order
    ``InputPipeline.batches`` yields over successive epochs, by global
    step, so the stream resumes mid-epoch from a cursor.
    """

    def __init__(self, ip: InputPipeline, w: WatershedWindows):
        self.ip = ip
        self.w = w
        self.steps_per_epoch = ip.num_batches(len(w.discharge))
        self._orders: Dict[int, np.ndarray] = {}

    def _order(self, epoch: int) -> np.ndarray:
        order = self._orders.get(epoch)
        if order is None:
            order = self.ip.epoch_order(self.w, epoch)
            # at most two epochs, evicted first in first out: a prefetcher
            # straddling an epoch boundary never recomputes one
            if len(self._orders) >= 2:
                self._orders.pop(next(iter(self._orders)))
            self._orders[epoch] = order
        return order

    def batch_at(self, epoch: int, i: int) -> Dict[str, np.ndarray]:
        bs = self.ip.batch_size
        return _pack(self.w, self._order(epoch)[i * bs:(i + 1) * bs])

    def host_batch(self, step: int) -> Dict[str, np.ndarray]:
        epoch, i = divmod(step, self.steps_per_epoch)
        return self.batch_at(epoch, i)


class StackedSource:
    """All local watersheds stacked on a leading axis (IP-D) as a
    ``DataSource``: the step-indexed twin of ``stacked_batches``."""

    def __init__(self, ip: InputPipeline):
        self.ip = ip
        self.steps_per_epoch = ip.steps_per_epoch()
        self._subs = [WatershedSource(ip, w) for w in ip.windows]

    def host_batch(self, step: int) -> Dict[str, np.ndarray]:
        epoch, i = divmod(step, self.steps_per_epoch)
        parts = [s.batch_at(epoch, i) for s in self._subs]
        return {k: np.stack([p[k] for p in parts]) for k in parts[0]}
