"""Run telemetry of the port: the counterpart of ``lightgbm_tpu/obs/``
for one training process on one card.

- :mod:`.schemas` — the JAX package's event, metric, env-var and
  fault-kind registries, copied;
- :mod:`.registry` — label-keyed, thread-safe counters / gauges /
  histograms (``registry`` is the process-global instance);
- :mod:`.export` — the registry as OpenMetrics text on a stdlib
  ``/metrics`` endpoint (``metrics_port`` /
  ``LIGHTGBM_TPU_METRICS_PORT``), and its strict parser;
- :func:`device_memory_stats` — the training device's allocator gauges;
- :class:`TelemetryRecorder` — one JSONL event per boosting iteration,
  activated by ``lightgbm_tpu_torch.telemetry(path)`` or
  ``LIGHTGBM_TPU_TELEMETRY=<path>``; ``summarize_events`` and
  ``render_stats_table`` read it back (``python -m lightgbm_tpu_torch
  stats <path>``);
- :mod:`.trace` — spans, Chrome trace JSON and critical paths
  (``python -m lightgbm_tpu_torch trace <dir>``).

The JAX package's XLA cost attribution (``obs/cost.py``) and recompile
tracker (``obs/jit_tracker.py``) are ROADMAP.md Queue 1 item 21's rest.
"""

from .export import (MetricsHTTPServer, ensure_metrics_server,
                     parse_openmetrics, render_openmetrics)
from .memory import device_memory_stats
from .recorder import (ITERATION_EVENT_KEYS, TelemetryRecorder,
                       UnknownEventError, merge_fleet_summaries,
                       render_fleet_table, render_stats_table,
                       summarize_directory, summarize_events)
from .registry import Counter, Gauge, Histogram, MetricsRegistry, registry
from .schemas import (ENV_VARS, EVENT_NAMES, EVENTS, FAULT_EVENT_KINDS,
                      FAULT_KINDS, METRICS, event_keys,
                      fault_event_kinds, injectable_fault_kinds,
                      one_shot_fault_kinds, required_keys)
from .trace import (SPAN_EVENT_KEYS, current_context, drain_span_events,
                    new_span_id, new_trace_id, record_span,
                    set_current_trace, span, span_events_snapshot)

__all__ = [
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "registry",
    "device_memory_stats",
    "TelemetryRecorder", "ITERATION_EVENT_KEYS", "UnknownEventError",
    "EVENTS", "EVENT_NAMES", "METRICS", "ENV_VARS", "FAULT_KINDS",
    "FAULT_EVENT_KINDS", "event_keys", "required_keys",
    "injectable_fault_kinds", "one_shot_fault_kinds",
    "fault_event_kinds",
    "summarize_events", "render_stats_table",
    "summarize_directory", "merge_fleet_summaries",
    "render_fleet_table",
    "render_openmetrics", "parse_openmetrics", "MetricsHTTPServer",
    "ensure_metrics_server",
    "SPAN_EVENT_KEYS", "record_span", "span", "drain_span_events",
    "span_events_snapshot", "new_trace_id", "new_span_id",
    "current_context", "set_current_trace",
]
