"""Serving-stack observability, host-side and stdlib only (counterpart of
``repro/obs``).

The paper's claims are latency claims, so the serving stack is observable
at the granularity it is tuned at: per request, per decode chunk, per
engine dispatch.

- :mod:`repro_torch.obs.trace`   — a ring-buffered span tracer with an
  injectable clock, exported as Chrome/Perfetto trace-event JSON
  (``python -m repro_torch.obs.trace`` captures a demo serve; ``/v1/trace``
  on the async server exports a live session).
- :mod:`repro_torch.obs.metrics` — counters / gauges / exponential-bucket
  histograms behind a thread-safe registry, exported as a JSON snapshot or
  Prometheus text (``/v1/metrics``); collectors add families read at
  scrape time (the kernels' launch census).

Contract: ``import repro_torch.obs`` loads neither torch nor jax nor the
reference package, and no module here imports anything but the standard
library at module level (``tests/test_torch_obs.py``). The hooks in
``infer/`` and ``launch/`` fire only between engine dispatches, never inside
a captured CUDA graph, so instrumented serving gives the tokens of
uninstrumented serving bit for bit. A span times the host call; the device
time of each engine scope is ``torch.profiler``'s (``record_function``
ranges of the same names).
"""

from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
    parse_prometheus,
    prometheus_text,
)
from repro_torch.obs.trace import Tracer, validate_chrome_trace

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Tracer",
    "default_registry",
    "parse_prometheus",
    "prometheus_text",
    "validate_chrome_trace",
]
