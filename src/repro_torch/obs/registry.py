"""Metric registry: counters, gauges, streaming histograms, labeled series.

A copy of the reference's ``repro/obs/registry.py`` (host code: numpy, no JAX), kept
bit-equal in behaviour by ``tests/test_torch_serve_lm.py``. The port adds
what its training spans need (``obs/profiler.py::span``): ``record`` and
``add``, which threads may call at once (the loader's worker records
beside the step); device samples whose value a pair of CUDA events gives
once the device has passed them (``defer``, resolved by ``poll`` without
waiting and by ``flush``, which ``snapshot`` and ``dump_jsonl`` call);
and one process-wide registry (``default``, swapped by ``as_default``)
for code that holds none of its own, such as the kernel builds.

One :class:`MetricRegistry` instance is the single store for every
host-side measurement a subsystem makes — the serving scheduler's
per-run / lifetime stats, per-request TTFT, decode-gap distributions,
training step timings, loader-wait gauges.  Code that used to keep flat
``stats`` dicts keeps its dict API through :class:`StatGroup` /
:class:`Series` views; the registry gains what the flat dicts never had:

  * HISTOGRAMS with quantiles — exact on smoke-sized runs (every sample
    is kept up to ``exact_max``), deterministic decimation beyond it:
    when the sample buffer overflows it is sorted and every second
    sample dropped (first and last kept), doubling the per-sample
    weight, so ``quantile`` stays an empirical-CDF read with bounded
    rank error and zero randomness.  ``count``/``sum``/``min``/``max``
    stay exact at any size;
  * a uniform SNAPSHOT (``snapshot()``) and JSONL dump
    (``dump_jsonl``) — one line per metric, histograms summarized as
    count/sum/min/max/mean/p50/p90/p99 — the ``--metrics-out`` file the
    launchers write and ``scripts/ci_smoke.py obs`` validates;
  * NAMING: dotted lowercase paths, ``<subsystem>.<metric>[_<unit>]``
    (``serve.ttft_s``, ``serve.decode_gap_s``, ``sched.run.<counter>``,
    ``train.step_s``).  Units ride the suffix (``_s`` seconds,
    ``_tokens``, ``_pages``) so downstream tooling never guesses.

Everything here is pure host-side Python: recording a metric can never
perturb a jitted computation, which is what keeps the tracing/metrics
bit-parity tests (``tests/test_obs.py``) trivially true.
"""
from __future__ import annotations

import json
import threading
import time
from collections.abc import MutableMapping
from contextlib import contextmanager
from typing import Any, Dict, Iterable, Iterator, Mapping, Tuple

import numpy as np


class Counter:
    """Monotonic float counter."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += float(n)


class Gauge:
    """Last-write-wins float value."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = float("nan")

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Streaming histogram with exact-on-smoke quantiles.

    All samples are kept verbatim until ``exact_max``; past that the
    sorted buffer is decimated in place (every second sample dropped,
    endpoints kept) and the per-sample ``weight`` doubles — a
    deterministic quantile sketch whose rank error halves the resolution
    per decimation but never depends on arrival order randomness.
    ``quantile(q)`` is ``numpy.percentile`` over the buffer, so in the
    exact regime it matches ``numpy.percentile`` of the raw stream
    bit for bit (the hypothesis property test in ``tests/test_obs.py``
    pins this).  ``count``/``sum``/``min``/``max``/``last`` are exact at
    any size.
    """

    def __init__(self, exact_max: int = 4096) -> None:
        if exact_max < 2:
            raise ValueError(f"exact_max must be >= 2, got {exact_max}")
        self.exact_max = int(exact_max)
        self._samples: list = []
        self.reset()

    def reset(self) -> None:
        """Drop every recorded sample (the per-run reset, mirroring
        ``StatGroup.reset``)."""
        self._samples.clear()
        self.weight = 1                 # stream samples per kept sample
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.last = float("nan")

    @property
    def exact(self) -> bool:
        return self.weight == 1

    def record(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        self.last = v
        # past the exact regime only every ``weight``-th stream sample
        # is buffered, so every kept sample represents the same stream
        # mass and repeated decimation cannot skew toward recent values
        if self.count % self.weight == 0:
            self._samples.append(v)
        if len(self._samples) > self.exact_max:
            s = sorted(self._samples)
            # keep endpoints so min/max stay representable in the sketch
            self._samples = s[0::2] + ([s[-1]] if len(s) % 2 == 0 else [])
            self.weight *= 2

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else float("nan")

    def quantile(self, q: float) -> float:
        """The ``q``-th percentile (0..100, numpy.percentile semantics);
        exact while no decimation has happened, NaN when empty."""
        if not self._samples:
            return float("nan")
        return float(np.percentile(np.asarray(self._samples, np.float64), q))

    def quantiles(self, qs: Iterable[float] = (50, 90, 99)) -> Dict[str, float]:
        return {f"p{_fmt_q(q)}": self.quantile(q) for q in qs}

    def summary(self) -> Dict[str, float]:
        return {"count": self.count, "sum": self.sum,
                "min": self.min if self.count else float("nan"),
                "max": self.max if self.count else float("nan"),
                "mean": self.mean, **self.quantiles()}


def _fmt_q(q: float) -> str:
    return str(int(q)) if float(q) == int(q) else str(q).replace(".", "_")


def percentiles(values, qs: Iterable[float] = (50, 99)) -> Dict[str, float]:
    """``{"p50": ..., "p99": ...}`` over ``values`` — THE percentile
    helper every consumer shares (``launch/serve.py`` for the JSON
    summary, ``benchmarks/serve_bench.py`` for its latency rows), so the
    interpolation rule can never drift between them.  NaNs on empty."""
    vals = np.asarray(list(values), np.float64)
    if vals.size == 0:
        return {f"p{_fmt_q(q)}": float("nan") for q in qs}
    return {f"p{_fmt_q(q)}": float(np.percentile(vals, q)) for q in qs}


class Series(MutableMapping):
    """Labeled value family (``name{label} -> float``) with a plain dict
    API — e.g. ``serve.ttft_s`` keyed by request id.  The scheduler's
    legacy ``sched.ttft`` dict is exactly this view, so existing callers
    (``benchmarks/serve_bench.py``) keep indexing it unchanged while the
    registry snapshot/dump sees every point."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._vals: Dict[Any, float] = {}

    def __getitem__(self, k: Any) -> float:
        return self._vals[k]

    def __setitem__(self, k: Any, v: float) -> None:
        self._vals[k] = float(v)

    def __delitem__(self, k: Any) -> None:
        del self._vals[k]

    def __iter__(self) -> Iterator:
        return iter(self._vals)

    def __len__(self) -> int:
        return len(self._vals)

    def __repr__(self) -> str:
        return f"Series({self.name!r}, {self._vals!r})"


class StatGroup(MutableMapping):
    """A fixed family of named scalars behind a dict API — the
    backward-compatible view that absorbs the scheduler's flat
    ``stats`` / ``lifetime_stats`` dicts.  Every existing access
    pattern keeps working (``g[k] += v``, ``g[k] = max(g[k], v)``,
    ``.items()``, ``dict(g)``); ``reset()`` restores the declared
    defaults (the per-run stats reset), and the registry's snapshot
    reports each key as ``<prefix>.<key>``."""

    def __init__(self, prefix: str, defaults: Mapping[str, float]) -> None:
        self.prefix = prefix
        self._defaults = dict(defaults)
        self._vals: Dict[str, float] = dict(defaults)

    def reset(self) -> None:
        self._vals = dict(self._defaults)

    def merge_defaults(self, defaults: Mapping[str, float]) -> None:
        for k, v in defaults.items():
            self._defaults.setdefault(k, v)
            self._vals.setdefault(k, v)

    def __getitem__(self, k: str) -> float:
        return self._vals[k]

    def __setitem__(self, k: str, v: float) -> None:
        self._vals[k] = v

    def __delitem__(self, k: str) -> None:
        del self._vals[k]

    def __iter__(self) -> Iterator[str]:
        return iter(self._vals)

    def __len__(self) -> int:
        return len(self._vals)

    def __repr__(self) -> str:
        return f"StatGroup({self.prefix!r}, {self._vals!r})"


class MetricRegistry:
    """Get-or-create store for every metric family; the single source a
    snapshot or ``--metrics-out`` dump reads."""

    def __init__(self) -> None:
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}
        self._series: Dict[str, Series] = {}
        self._groups: Dict[str, StatGroup] = {}
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        self._deferred: list = []       # (name, start event, end event)

    # -- get-or-create accessors ------------------------------------------
    def counter(self, name: str) -> Counter:
        return self._counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        return self._gauges.setdefault(name, Gauge())

    def histogram(self, name: str, exact_max: int = 4096) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram(exact_max=exact_max)
        return h

    def series(self, name: str) -> Series:
        s = self._series.get(name)
        if s is None:
            s = self._series[name] = Series(name)
        return s

    def group(self, prefix: str, defaults: Mapping[str, float], *,
              reset: bool = False) -> StatGroup:
        g = self._groups.get(prefix)
        if g is None:
            g = self._groups[prefix] = StatGroup(prefix, defaults)
        else:
            g.merge_defaults(defaults)
            if reset:
                g.reset()
        return g

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    # -- recording from several threads -------------------------------------
    def record(self, name: str, v: float) -> None:
        """A sample of the histogram ``name``, under the registry's lock."""
        with self._lock:
            self.histogram(name).record(v)

    def add(self, name: str, n: float = 1.0) -> None:
        """``n`` more on the counter ``name``, under the registry's lock."""
        with self._lock:
            self.counter(name).inc(n)

    def defer(self, name: str, start, end) -> None:
        """A sample of ``name``: the seconds between two recorded CUDA
        events (anything with ``query``, ``synchronize`` and
        ``elapsed_time`` in ms), taken once the device has passed ``end``."""
        with self._lock:
            self._deferred.append((name, start, end))

    def poll(self) -> None:
        """Record the deferred samples whose events the device has passed;
        never waits for it."""
        if self._deferred:
            self._resolve(wait=False)

    def flush(self) -> None:
        """Wait for the device to pass every deferred sample's events and
        record them all. Outside a step: readers and dumps call it."""
        if self._deferred:
            self._resolve(wait=True)

    def _resolve(self, wait: bool) -> None:
        with self._lock:
            left = []
            for name, a, b in self._deferred:
                if wait:
                    b.synchronize()
                elif not (b.query() and a.query()):
                    left.append((name, a, b))
                    continue
                self.histogram(name).record(a.elapsed_time(b) * 1e-3)
            self._deferred = left

    # -- export ------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Flat ``{dotted name: value}`` view: scalars directly,
        histograms as summary dicts, series as ``name{label}`` keys."""
        self.flush()
        out: Dict[str, Any] = {}
        for name, c in self._counters.items():
            out[name] = c.value
        for name, g in self._gauges.items():
            out[name] = g.value
        for prefix, grp in self._groups.items():
            for k, v in grp.items():
                out[f"{prefix}.{k}"] = v
        for name, h in self._hists.items():
            out[name] = h.summary()
        for name, s in self._series.items():
            for label, v in s.items():
                out[f"{name}{{{label}}}"] = v
        return out

    def _lines(self) -> Iterator[Tuple[str, Dict[str, Any]]]:
        for name, c in self._counters.items():
            yield name, {"type": "counter", "value": c.value}
        for name, g in self._gauges.items():
            yield name, {"type": "gauge", "value": g.value}
        for prefix, grp in self._groups.items():
            for k, v in grp.items():
                yield f"{prefix}.{k}", {"type": "counter", "value": v}
        for name, h in self._hists.items():
            yield name, {"type": "histogram", **h.summary(),
                         "exact": h.exact}
        for name, s in self._series.items():
            for label, v in s.items():
                yield name, {"type": "series", "label": str(label),
                             "value": v}

    def dump_jsonl(self, path: str) -> None:
        """One JSON object per line: ``{"name", "type", ...}`` —
        counters/gauges carry ``value``, histograms their summary
        (count/sum/min/max/mean/p50/p90/p99), series one line per label.
        The schema ``benchmarks/README.md`` documents and the ``obs`` CI
        smoke validates."""
        self.flush()
        with open(path, "w") as f:
            for name, doc in self._lines():
                f.write(json.dumps({"name": name, **_finite(doc)}) + "\n")


_default = MetricRegistry()


def default() -> MetricRegistry:
    """The process-wide registry: where an ``Engine`` built without one,
    its loader and the kernel builds record."""
    return _default


@contextmanager
def as_default(registry: MetricRegistry):
    """``registry`` as the process-wide one for the block (a launcher's
    run), the previous one again after it."""
    global _default
    prev, _default = _default, registry
    try:
        yield registry
    finally:
        _default = prev


def _finite(doc: Dict[str, Any]) -> Dict[str, Any]:
    """NaN/inf -> None so the JSONL stays strict-JSON parseable."""
    out = {}
    for k, v in doc.items():
        if isinstance(v, float) and not np.isfinite(v):
            v = None
        out[k] = v
    return out
