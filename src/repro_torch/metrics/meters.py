"""Host-side metric accumulation for training loops, over the registry: a
copy of the reference's ``metrics/meters.py``.

:class:`Meter` keeps the ``update``/``mean``/``last``/``elapsed``/
``summary`` API, and every ``update`` lands in a
:class:`~repro_torch.obs.registry.Histogram` of a shared
:class:`~repro_torch.obs.registry.MetricRegistry`, so the launcher's
``--metrics-out`` JSONL dump sees every metered key (as
``<prefix><key>``) without a second bookkeeping path.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.obs.registry import Histogram, MetricRegistry


class Meter:
    """Thin named-histogram view over a :class:`MetricRegistry`.

    ``Meter()`` with no arguments owns a private registry; pass
    ``registry=`` to share the launcher's store, and ``prefix=`` to
    namespace the metered keys in it (``prefix="train."`` puts
    ``update(loss=...)`` under ``train.loss``).
    """

    def __init__(self, registry: Optional[MetricRegistry] = None,
                 prefix: str = "") -> None:
        self.registry = registry if registry is not None else MetricRegistry()
        self.prefix = prefix
        self._keys: Dict[str, str] = {}     # metered key -> registry name

    def _hist(self, key: str) -> Histogram:
        name = self._keys.get(key)
        if name is None:
            name = self._keys[key] = f"{self.prefix}{key}"
        return self.registry.histogram(name)

    def update(self, **metrics: float) -> None:
        for k, v in metrics.items():
            self._hist(k).record(float(v))

    def mean(self, key: str) -> float:
        return self._hist(key).mean

    def last(self, key: str) -> float:
        return self._hist(key).last

    def elapsed(self) -> float:
        return self.registry.elapsed()

    def summary(self) -> Dict[str, float]:
        return {k: self.mean(k) for k in self._keys}
