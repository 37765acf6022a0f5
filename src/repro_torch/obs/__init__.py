"""Telemetry: metric registry, request-lifecycle tracer and the optional
``torch.profiler`` hooks, ports of the reference's host-side
``repro/obs`` modules (its profiler wraps ``jax.profiler``)."""
from repro_torch.obs import profiler  # noqa: F401
from repro_torch.obs.registry import (  # noqa: F401
    Counter, Gauge, Histogram, MetricRegistry, Series, StatGroup, percentiles,
)
from repro_torch.obs.trace import (  # noqa: F401
    Tracer, derive_request_metrics, span_coverage,
)
