"""The serving tier, ported from ``repro/serving`` (DESIGN.md §9).

- :mod:`repro_torch.serving.paged_cache` — block/paged KV cache: fixed-size
  pages, slot→page block tables, host-side free-list allocation.
- :mod:`repro_torch.serving.server` — the continuous-batching server.
- :mod:`repro_torch.serving.router` — prefill/decode disaggregation over a
  mixed :class:`~repro_torch.core.cost_model.ClusterSpec`.
- :mod:`repro_torch.serving.traffic` — open-loop heavy-tail (Pareto)
  arrivals.
- :mod:`repro_torch.serving.metrics` — per-request TTFT/TPOT/e2e
  accounting.
- :mod:`repro_torch.serving.sim` — the analytic discrete-event serving
  simulator.

Exported under the reference's names (``repro/serving/__init__.py``).
"""
from repro_torch.serving.metrics import RequestTiming, ServeMetrics, percentile
from repro_torch.serving.paged_cache import PageAllocator, PagedCacheConfig
from repro_torch.serving.router import DisaggPlan, route
from repro_torch.serving.traffic import Arrival, TrafficCfg, make_trace

__all__ = [
    "Arrival", "DisaggPlan", "PageAllocator", "PagedCacheConfig",
    "RequestTiming", "ServeMetrics", "TrafficCfg", "make_trace",
    "percentile", "route",
]
