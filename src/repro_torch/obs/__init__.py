"""Telemetry: metric registry and request-lifecycle tracer, copies of the
reference's host-side ``repro/obs`` modules. The reference's
``jax.profiler`` hooks (``obs/profiler.py``) are not ported yet."""
from repro_torch.obs.registry import (  # noqa: F401
    Counter, Gauge, Histogram, MetricRegistry, Series, StatGroup, percentiles,
)
from repro_torch.obs.trace import (  # noqa: F401
    Tracer, derive_request_metrics, span_coverage,
)
