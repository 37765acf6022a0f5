"""Prefetching data loading: the paper's input pipeline ("I.P.", Fig. 2a)
on one device.

A copy of the reference's ``data/loader.py`` with the placement done by
PyTorch on one card instead of ``jax.device_put`` onto a mesh:

  * :class:`DataSource` — a random-access batch protocol:
    ``host_batch(step)`` returns the host (numpy) batch for a global step.
    Epoch shuffles are seeded from ``(seed, watershed, epoch)`` with
    ``epoch = step // steps_per_epoch``, so the global step doubles as a
    resumable stream cursor: restarting the source at a restored step
    replays the stream an uninterrupted run would have seen, mid-epoch
    included.

  * :class:`ShardedLoader` — wraps a DataSource and an ``Engine``: each
    host batch is placed on the engine's device by ``engine.place_batch``,
    and a background thread runs ``prefetch`` batches ahead of the
    consumer. ``prefetch=0`` is the synchronous path (same batches, same
    placement, no thread).

On the card the worker copies each batch on a stream of its own, so the
copy overlaps the step running on the consumer's stream. The copy is a
blocking one (it waits for the worker's stream alone, never the step's),
an event recorded after it is waited on by the consumer's stream before
the batch is handed over, and each tensor is marked as used by that
stream (``record_stream``), so the allocator does not give its memory to
the worker's next batch while the step may still read it.
"""
from __future__ import annotations

import itertools
import queue
import threading
from typing import Dict, Iterator, Optional, Protocol, runtime_checkable

import numpy as np
import torch


@runtime_checkable
class DataSource(Protocol):
    """Random-access host-batch stream indexed by global step."""

    #: steps per epoch for epoch-shuffled sources; None for endless streams
    steps_per_epoch: Optional[int]

    def host_batch(self, step: int) -> Dict[str, np.ndarray]:
        """The host batch for global step ``step`` (deterministic)."""
        ...


class ShardedLoader:
    """Prefetching iterator of placed batches over a :class:`DataSource`.

    Args:
      source: the batch stream (``host_batch(step)``).
      engine: a ``repro_torch.train.Engine``: supplies ``device`` and
        ``place_batch``, which puts a host batch on the device in the
        layout the step takes.
      prefetch: background-queue depth; >= 2 double-buffers the host work
        and the copy behind the step, 0 means synchronous (no thread).
      start_step: the stream cursor to (re)start from; pass the restored
        ``int(state.step)`` to resume a checkpointed run in place.
      num_steps: batches yielded per ``iter()`` (None = endless).

    ``loader.cursor`` always names the next step to be consumed, so after
    ``state, m = engine.step(state, batch)`` it equals ``int(state.step)``.
    """

    _DONE = object()
    _ERR = object()

    def __init__(self, source: DataSource, engine, *, prefetch: int = 2,
                 start_step: int = 0, num_steps: Optional[int] = None):
        self.source = source
        self.engine = engine
        self.prefetch = int(prefetch)
        self.cursor = int(start_step)
        self.num_steps = num_steps

    def _steps(self):
        if self.num_steps is None:
            return itertools.count(self.cursor)
        return range(self.cursor, self.cursor + int(self.num_steps))

    def _place(self, step: int):
        return self.engine.place_batch(self.source.host_batch(step))

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        if self.prefetch <= 0:                 # synchronous reference path
            for s in self._steps():
                batch = self._place(s)
                self.cursor = s + 1
                yield batch
            return

        steps = self._steps()
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        dev = torch.device(self.engine.device)
        side = torch.cuda.Stream(dev) if dev.type == "cuda" else None

        def put(item) -> bool:
            # bounded put that gives up once the consumer has left, so an
            # abandoned iterator never wedges the worker on a full queue
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def place(s: int):
            if side is None:
                return self._place(s), None
            with torch.cuda.stream(side):
                batch = self._place(s)
                ready = torch.cuda.Event()
                ready.record(side)
            return batch, ready

        def worker() -> None:
            try:
                for s in steps:
                    if stop.is_set() or not put((s, *place(s))):
                        return
            except BaseException as e:         # re-raised on the consumer side
                put((self._ERR, e, None))
            else:
                put((self._DONE, None, None))

        t = threading.Thread(target=worker, name="sharded-loader-prefetch",
                             daemon=True)
        t.start()
        try:
            while True:
                tag, item, ready = q.get()
                if tag is self._DONE:
                    return
                if tag is self._ERR:
                    raise item
                if ready is not None:
                    cur = torch.cuda.current_stream(dev)
                    cur.wait_event(ready)
                    for v in item.values():
                        v.record_stream(cur)
                self.cursor = tag + 1
                yield item
        finally:
            stop.set()
            t.join(timeout=10)
