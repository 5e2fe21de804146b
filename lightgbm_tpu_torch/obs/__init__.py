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
  (``python -m lightgbm_tpu_torch trace <dir>``);
- :mod:`.jit_tracker` — :class:`RecompileWatcher`: the port has no jit
  cache, so it counts what takes its place, kernel builds by ``nvcc``
  and new padded row shapes of the compiled forest's walk;
  ``jit_tracker.register_jit`` wraps an entry point for cost attribution
  and declares its ``max_signatures`` (:func:`jit_declarations`);
- :mod:`.cost` — cost attribution: one ``{"event": "compile"}`` record
  per entry point and new call signature, with the kernels' modelled and
  the torch ops' counted flops and bytes against the card's peaks
  (``stats`` prints them as its cost section).
"""

# the registry is bound here, eagerly and torch-free, so that the
# package attribute ``registry`` is the process-global instance and
# never the submodule of that name
from .registry import Counter, Gauge, Histogram, MetricsRegistry, registry

# every other name loads on first access (PEP 562): the span log and the
# exporter are torch-free, and the serving daemon's parse path, the
# store and the publisher import them without torch
_LAZY = {
    "MetricsHTTPServer": "export", "ensure_metrics_server": "export",
    "parse_openmetrics": "export", "render_openmetrics": "export",
    "device_memory_stats": "memory", "ITERATION_EVENT_KEYS": "recorder",
    "TelemetryRecorder": "recorder", "UnknownEventError": "recorder",
    "merge_fleet_summaries": "recorder", "render_fleet_table": "recorder",
    "render_stats_table": "recorder", "summarize_directory": "recorder",
    "summarize_events": "recorder", "ENV_VARS": "schemas", "EVENT_NAMES": "schemas", "EVENTS": "schemas",
    "FAULT_EVENT_KINDS": "schemas", "FAULT_KINDS": "schemas",
    "METRICS": "schemas", "event_keys": "schemas",
    "fault_event_kinds": "schemas", "injectable_fault_kinds": "schemas",
    "one_shot_fault_kinds": "schemas", "required_keys": "schemas",
    "SPAN_EVENT_KEYS": "trace", "current_context": "trace",
    "drain_span_events": "trace", "new_span_id": "trace",
    "new_trace_id": "trace", "record_span": "trace",
    "set_current_trace": "trace", "span": "trace",
    "span_events_snapshot": "trace", "RecompileWatcher": "jit_tracker",
    "jit_cache_sizes": "jit_tracker", "total_recompiles": "jit_tracker",
    "register_jit": "jit_tracker", "jit_declarations": "jit_tracker",
    "CostTracked": "cost", "drain_compile_events": "cost",
    "compile_events_snapshot": "cost", "device_peaks": "cost",
    "roofline_optimal_ms": "cost", "cost_wrap_enabled": "cost",
    "DEVICE_PEAKS": "cost",
}

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
    "RecompileWatcher", "jit_cache_sizes", "total_recompiles",
    "register_jit", "jit_declarations",
    "CostTracked", "drain_compile_events", "compile_events_snapshot",
    "device_peaks", "roofline_optimal_ms", "cost_wrap_enabled",
    "DEVICE_PEAKS",
]


def __getattr__(name):
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib
    value = getattr(importlib.import_module(f".{target}", __name__), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
