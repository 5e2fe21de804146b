"""The cross-process wire contracts: a copy of
``lightgbm_tpu/obs/schemas.py``.

JSONL ``{"event": ...}`` records, metrics-registry family names,
``LIGHTGBM_TPU_*`` environment variables and fault-kind strings are
declared here with the JAX package's names, keys and defaults, so a
deployment that sets the variables gets the same behaviour from either
package and a stream one package writes is read by the other's
``stats`` and ``trace``. The port emits a subset of them (``iteration``,
``ingest``, ``fault`` and ``span`` events; the training families of
``METRICS``); the rest are declared for the readers.
"""

from __future__ import annotations

__all__ = ["EVENTS", "METRICS", "EXPORT_FAMILIES", "ENV_VARS",
           "FAULT_KINDS", "FAULT_EVENT_KINDS", "EVENT_NAMES",
           "event_keys", "required_keys", "one_shot_fault_kinds",
           "injectable_fault_kinds", "fault_event_kinds"]

# ---------------------------------------------------------------------
# 1. JSONL events: name -> required/optional key sets
# ---------------------------------------------------------------------
# ``required`` keys are present on EVERY line of the event (in this
# order for events whose writer builds the dict from the tuple);
# ``optional`` keys may appear (``**stats``-style spreads, manifest
# payloads, degraded modes). A consumer may only reference declared
# keys; an emitter may only emit declared events and keys (TPL015).

EVENTS = {
    "iteration": {
        "doc": "one line per boosting iteration "
               "(obs/recorder.py record_iteration)",
        "required": ("event", "iteration", "wall_time", "phases",
                     "recompiles", "hbm", "tree", "eval", "comm",
                     "scan"),
        "optional": (),
    },
    "ingest": {
        "doc": "one line per streamed-ingest build "
               "(data/ingest.py two-pass pipeline)",
        "required": ("event",),
        "optional": ("rows", "features", "used_features", "chunks",
                     "chunk_rows", "sample_rows", "pass1_s", "pass2_s",
                     "host_binned_bytes", "source", "world",
                     "label_hash"),
    },
    "fault": {
        "doc": "one line per injected or observed fault "
               "(resilience/faults.py append_fault_event)",
        "required": ("event", "kind", "iteration", "action", "detail",
                     "time"),
        "optional": (),
    },
    "compile": {
        "doc": "one line per XLA compile with cost attribution "
               "(obs/cost.py)",
        "required": ("event", "entry", "signature", "flops",
                     "bytes_accessed", "wall_ms", "compiles",
                     "device_kind", "peak_flops", "peak_bytes_per_sec",
                     "optimal_ms", "time"),
        "optional": (),
    },
    "span": {
        "doc": "one distributed-tracing span "
               "(obs/trace.py make_span)",
        "required": ("event", "name", "trace_id", "span_id",
                     "parent_id", "wall", "mono", "dur", "proc",
                     "attrs"),
        "optional": (),
    },
    "serve": {
        "doc": "periodic serve-daemon stats snapshot "
               "(serve/daemon.py emit_serve_event)",
        "required": ("event",),
        "optional": ("queue_depth_rows", "requests_total", "rows_total",
                     "batches_total", "swaps_total", "rejected_total",
                     "shed_total", "shed_rows", "p50_ms", "p99_ms",
                     "model", "model_source", "manifest",
                     "swap_failures", "shed_replies", "draining",
                     "uptime_s", "qps", "rows_per_sec", "recompiles",
                     "hbm"),
    },
    "serve_ready": {
        "doc": "serve-daemon startup handshake on stdout "
               "(serve/daemon.py main)",
        "required": ("event", "host", "port", "pid", "rank", "model",
                     "model_source", "watch_dir", "metrics_port",
                     "buckets"),
        "optional": (),
    },
    "publish": {
        "doc": "one line per atomic model publication; the manifest "
               "rides along (resilience/publisher.py, pipeline.py)",
        "required": ("event",),
        "optional": ("file", "sha256", "generation", "train_auc",
                     "size_bytes", "trees", "time", "canary",
                     "model_id", "attempts"),
    },
    "published": {
        "doc": "publisher CLI success line on stdout (pipeline.py "
               "publish_generation)",
        "required": ("event", "generation", "file", "sha256",
                     "train_auc"),
        "optional": (),
    },
    "fleet": {
        "doc": "one supervisor scrape over replica or rank /metrics "
               "endpoints (resilience/elastic.py)",
        "required": ("event", "shape", "time"),
        "optional": ("replicas", "restarts_total", "nprocs", "ranks",
                     "iteration_skew"),
    },
    "autoscale": {
        "doc": "one line per fleet scaling action "
               "(resilience/elastic.py)",
        "required": ("event", "action", "rank", "replicas", "reason",
                     "time"),
        "optional": (),
    },
    "rollback": {
        "doc": "one line per canary/health-ordered publication "
               "rollback (resilience/elastic.py)",
        "required": ("event", "bad_file", "bad_sha", "good_file",
                     "good_sha", "time"),
        "optional": (),
    },
    "client": {
        "doc": "load-generator client-side view "
               "(pipeline.py LoadGenerator)",
        "required": ("event", "time"),
        "optional": ("attempts", "ok", "shed", "overloaded", "draining",
                     "error", "conn", "timeout", "max_ok_gap_s",
                     "model", "since_last_ok_s", "p50_ms", "p99_ms"),
    },
    "pipeline": {
        "doc": "pipeline-supervisor lifecycle phase marker "
               "(pipeline.py)",
        "required": ("event", "phase", "time"),
        "optional": ("generation", "generations", "rc", "trace_id",
                     "rate", "ports", "replicas", "max_replicas",
                     "warm_start", "fault_inject", "sha256", "bad_sha",
                     "good_sha", "good_file"),
    },
    "pipeline_summary": {
        "doc": "the pipeline run's final scorecard (pipeline.py "
               "_finish)",
        "required": ("event", "generations_requested",
                     "generations_published", "swaps_confirmed",
                     "rollbacks", "last_published_sha256",
                     "last_published_generation",
                     "train_auc_by_generation", "failures", "time"),
        "optional": ("fleet", "fleet_lifecycle", "client"),
    },
}

# ---------------------------------------------------------------------
# 2. metrics-registry families: name -> kind + label names
# ---------------------------------------------------------------------
# Every ``registry.counter/gauge/histogram`` / ``bump_counter`` call
# in the package must name a family declared here with the declared
# kind and label set; declared-but-never-bumped families are lint
# findings too (TPL016).

METRICS = {
    # training loop (obs/recorder.py _feed_registry)
    "iterations": {
        "kind": "counter", "labels": (),
        "doc": "boosting iterations recorded"},
    "jit_recompiles": {
        "kind": "counter", "labels": (),
        "doc": "XLA recompiles observed by the recompile watcher"},
    "phase_seconds": {
        "kind": "histogram", "labels": ("phase",),
        "doc": "per-iteration Timer phase seconds"},
    "hbm_bytes_in_use": {
        "kind": "gauge", "labels": (),
        "doc": "device HBM bytes in use after the iteration"},
    "hbm_peak_bytes_in_use": {
        "kind": "gauge", "labels": (),
        "doc": "device HBM peak bytes in use"},
    "tree_leaves": {
        "kind": "histogram", "labels": (),
        "doc": "leaves per finished tree"},
    "tree_split_gain_sum": {
        "kind": "histogram", "labels": (),
        "doc": "summed split gain per finished tree"},
    "comm_bytes": {
        "kind": "counter", "labels": ("mode", "wire"),
        "doc": "collective payload bytes by parallelism mode and "
               "hist_comm wire format"},
    "fused_scan_iterations": {
        "kind": "counter", "labels": (),
        "doc": "iterations that ran inside a fused scan window"},
    "fused_scan_windows": {
        "kind": "counter", "labels": (),
        "doc": "fused scan windows dispatched (models/gbdt.py)"},
    # ingestion (data/ingest.py, basic.py, parallel/placement.py)
    "ingest_chunks": {
        "kind": "counter", "labels": (),
        "doc": "row chunks streamed through two-pass ingestion"},
    "ingest_rows": {
        "kind": "counter", "labels": (),
        "doc": "rows streamed through two-pass ingestion"},
    "host_binned_bytes": {
        "kind": "gauge", "labels": (),
        "doc": "host footprint of this rank's binned shard (drops to "
               "~0 after device placement)"},
    # distributed init + collectives (parallel/, resilience/watchdog)
    "init_retries": {
        "kind": "counter", "labels": (),
        "doc": "distributed-init connection retries"},
    "init_backoff_seconds": {
        "kind": "counter", "labels": (),
        "doc": "seconds slept in distributed-init backoff"},
    "collective_timeouts": {
        "kind": "counter", "labels": (),
        "doc": "host collectives aborted by the watchdog deadline"},
    # faults (resilience/faults.py)
    "fault_events": {
        "kind": "counter", "labels": ("kind",),
        "doc": "fault events recorded, by kind"},
    # XLA cost attribution (obs/cost.py)
    "xla_compiles": {
        "kind": "counter", "labels": ("entry",),
        "doc": "XLA compiles per jit entry point"},
    "xla_compile_ms": {
        "kind": "histogram", "labels": ("entry",),
        "doc": "per-compile wall ms per entry point"},
    "xla_flops": {
        "kind": "gauge", "labels": ("entry",),
        "doc": "cost-model flops of the newest compiled program"},
    "xla_bytes_accessed": {
        "kind": "gauge", "labels": ("entry",),
        "doc": "cost-model bytes accessed of the newest compiled "
               "program"},
    # serve daemon (serve/daemon.py)
    "serve_swaps": {
        "kind": "counter", "labels": (),
        "doc": "hot model swaps completed"},
    "serve_swap_failures": {
        "kind": "counter", "labels": (),
        "doc": "hot model swaps refused or failed"},
    "serve_shed_requests": {
        "kind": "counter", "labels": (),
        "doc": "requests shed by the admission gate"},
    "serve_queue_depth_rows": {
        "kind": "gauge", "labels": (),
        "doc": "rows queued in the batcher"},
    # publisher (resilience/publisher.py)
    "publish_total": {
        "kind": "counter", "labels": (),
        "doc": "successful atomic publications"},
    "publish_retries": {
        "kind": "counter", "labels": (),
        "doc": "publication attempts retried"},
    "publish_backoff_seconds": {
        "kind": "counter", "labels": (),
        "doc": "seconds slept in publish retry backoff"},
    "publish_failures": {
        "kind": "counter", "labels": (),
        "doc": "publications that exhausted their retry budget"},
    "publish_pruned": {
        "kind": "counter", "labels": (),
        "doc": "superseded artifacts pruned from the store"},
    "publish_rollbacks": {
        "kind": "counter", "labels": (),
        "doc": "publications rolled back to last-known-good"},
    # supervisors (resilience/elastic.py)
    "supervisor_restarts": {
        "kind": "counter", "labels": (),
        "doc": "worker restarts by the single-rank supervisor"},
    "supervisor_backoff_seconds": {
        "kind": "counter", "labels": (),
        "doc": "seconds slept in supervisor restart backoff"},
    "elastic_restarts": {
        "kind": "counter", "labels": (),
        "doc": "whole-world restarts by the elastic supervisor"},
    "fleet_scale_ups": {
        "kind": "counter", "labels": (),
        "doc": "autoscale scale-up actions"},
    "fleet_scale_downs": {
        "kind": "counter", "labels": (),
        "doc": "autoscale scale-down actions"},
    "fleet_rollbacks": {
        "kind": "counter", "labels": (),
        "doc": "publication rollbacks ordered by the fleet guard"},
    "fleet_replicas_active": {
        "kind": "gauge", "labels": (),
        "doc": "serve replicas currently live"},
    "fleet_replica_up": {
        "kind": "gauge", "labels": ("replica",),
        "doc": "1 when the replica answered its last scrape"},
    "fleet_replica_restarts": {
        "kind": "gauge", "labels": ("replica",),
        "doc": "restarts of the replica so far"},
    "fleet_replica_qps": {
        "kind": "gauge", "labels": ("replica",),
        "doc": "replica requests/s at the last scrape"},
    "fleet_replica_p99_ms": {
        "kind": "gauge", "labels": ("replica",),
        "doc": "replica p99 latency ms at the last scrape"},
    "fleet_replica_shed": {
        "kind": "gauge", "labels": ("replica",),
        "doc": "replica shed total at the last scrape"},
    "fleet_rank_up": {
        "kind": "gauge", "labels": ("rank",),
        "doc": "1 when the training rank answered its last scrape"},
    "fleet_rank_iterations": {
        "kind": "gauge", "labels": ("rank",),
        "doc": "the rank's iteration counter at the last scrape"},
    "fleet_iteration_skew": {
        "kind": "gauge", "labels": (),
        "doc": "max-min iteration spread across live ranks"},
}

# ---------------------------------------------------------------------
# 2b. rendered-only OpenMetrics families (obs/export.py extra_families)
# ---------------------------------------------------------------------
# These appear on /metrics but are computed per scrape from live
# snapshots, never stored in the registry; declared so the docs table
# and the fleet scraper's sample names stay honest.

EXPORT_FAMILIES = {
    "serve_requests": {
        "kind": "counter",
        "doc": "requests accepted by the serve daemon"},
    "serve_rows": {
        "kind": "counter", "doc": "rows predicted"},
    "serve_batches": {
        "kind": "counter", "doc": "device batches dispatched"},
    "serve_rejected": {
        "kind": "counter", "doc": "malformed requests rejected"},
    "serve_shed": {
        "kind": "counter", "doc": "requests shed under overload"},
    "serve_shed_rows": {
        "kind": "counter", "doc": "rows shed under overload"},
    "serve_queue_depth_rows": {
        "kind": "gauge", "doc": "rows queued in the batcher"},
    "serve_p50_ms": {
        "kind": "gauge", "doc": "p50 request latency ms"},
    "serve_p99_ms": {
        "kind": "gauge", "doc": "p99 request latency ms"},
    "serve_qps": {
        "kind": "gauge", "doc": "requests/s over the stats window"},
    "serve_rows_per_sec": {
        "kind": "gauge", "doc": "rows/s over the stats window"},
    "serve_model_info": {
        "kind": "gauge",
        "doc": "always 1; model id and publication sha ride the "
               "labels"},
    "hbm_bytes_in_use": {
        "kind": "gauge", "doc": "device HBM bytes in use"},
    "hbm_peak_bytes_in_use": {
        "kind": "gauge", "doc": "device HBM peak bytes"},
    "client_attempts": {
        "kind": "counter", "doc": "load-generator request attempts"},
    "client_ok": {
        "kind": "counter", "doc": "load-generator successes"},
    "client_shed": {
        "kind": "counter", "doc": "replies shed by the daemon"},
    "client_overloaded": {
        "kind": "counter", "doc": "overloaded replies"},
    "client_draining": {
        "kind": "counter", "doc": "draining replies"},
    "client_error": {
        "kind": "counter", "doc": "error replies"},
    "client_conn": {
        "kind": "counter", "doc": "connection failures"},
    "client_timeout": {
        "kind": "counter", "doc": "request timeouts"},
    "client_p50_ms": {
        "kind": "gauge", "doc": "client-side p50 latency ms"},
    "client_p99_ms": {
        "kind": "gauge", "doc": "client-side p99 latency ms"},
    "client_max_ok_gap_s": {
        "kind": "gauge", "doc": "longest gap between successes"},
    "client_since_last_ok_s": {
        "kind": "gauge", "doc": "seconds since the last success"},
}

# ---------------------------------------------------------------------
# 3. LIGHTGBM_TPU_* environment variables
# ---------------------------------------------------------------------
# ``default`` is the string every ``environ.get`` site must claim
# (None: the variable has no default — read sites must not invent
# one; that is exactly the multi-site-default drift TPL017 exists to
# catch). ``kind`` is documentation (flag/int/float/str/path/spec).

ENV_VARS = {
    "LIGHTGBM_TPU_RANK": {
        "default": None, "kind": "int",
        "doc": "this process's rank; exported by the supervisors, "
               "read by distributed init, telemetry labels, serve "
               "and fault gating (unset: single-process)"},
    "LIGHTGBM_TPU_NUM_PROCS": {
        "default": None, "kind": "int",
        "doc": "world size for explicit-env distributed init"},
    "LIGHTGBM_TPU_COORDINATOR": {
        "default": None, "kind": "str",
        "doc": "host:port of the jax.distributed coordinator"},
    "LIGHTGBM_TPU_RESTART_COUNT": {
        "default": None, "kind": "int",
        "doc": "elastic-supervisor generation counter exported to "
               "workers (0 on first launch)"},
    "LIGHTGBM_TPU_TELEMETRY": {
        "default": None, "kind": "path",
        "doc": "JSONL telemetry stream path; rank N appends .rankN, "
               "the fleet supervisor appends .fleet"},
    "LIGHTGBM_TPU_METRICS_PORT": {
        "default": None, "kind": "int",
        "doc": "OpenMetrics /metrics port; worker rank r binds "
               "port+r (supervisors export base+1)"},
    "LIGHTGBM_TPU_TIMETAG": {
        "default": "", "kind": "flag",
        "doc": "enable the phase Timer ('' or '0': disabled)"},
    "LIGHTGBM_TPU_TRACE_TO": {
        "default": None, "kind": "path",
        "doc": "jax profiler trace output directory"},
    "LIGHTGBM_TPU_XPROF": {
        "default": None, "kind": "spec",
        "doc": "xprof capture spec for the bench harness"},
    "LIGHTGBM_TPU_TRACE_CTX": {
        "default": None, "kind": "spec",
        "doc": "trace_id:span_id inherited by spawned workers so "
               "their spans join the parent trace"},
    "LIGHTGBM_TPU_COST_ATTRIBUTION": {
        "default": "1", "kind": "flag",
        "doc": "record per-compile XLA cost events ('0': off)"},
    "LIGHTGBM_TPU_COST_OPTIMIZED": {
        "default": "", "kind": "flag",
        "doc": "assert the cost-model roofline in bench mode"},
    "LIGHTGBM_TPU_PEAK_TFLOPS": {
        "default": None, "kind": "float",
        "doc": "override the device peak TFLOP/s for the roofline"},
    "LIGHTGBM_TPU_PEAK_GBPS": {
        "default": None, "kind": "float",
        "doc": "override the device peak HBM GB/s for the roofline"},
    "LIGHTGBM_TPU_CHECKPOINT": {
        "default": None, "kind": "path",
        "doc": "checkpoint directory; implies auto-checkpoint and "
               "auto-resume"},
    "LIGHTGBM_TPU_CHECKPOINT_EVERY": {
        "default": "1", "kind": "int",
        "doc": "checkpoint cadence in iterations"},
    "LIGHTGBM_TPU_COLLECTIVE_TIMEOUT": {
        "default": None, "kind": "float",
        "doc": "host-collective watchdog deadline seconds (overrides "
               "Config.collective_timeout_sec; 0 disables)"},
    "LIGHTGBM_TPU_FAULT_INJECT": {
        "default": "", "kind": "spec",
        "doc": "comma list of kind@iteration chaos tokens "
               "(docs/RESILIENCE.md)"},
    "LIGHTGBM_TPU_FAULT_RANK": {
        "default": "0", "kind": "spec",
        "doc": "comma list of ranks distributed faults fire on"},
    "LIGHTGBM_TPU_INIT_RETRIES": {
        "default": "10", "kind": "int",
        "doc": "distributed-init connection attempts"},
    "LIGHTGBM_TPU_INIT_BACKOFF": {
        "default": "0.5", "kind": "float",
        "doc": "base seconds of distributed-init backoff"},
    "LIGHTGBM_TPU_INIT_TIMEOUT": {
        "default": None, "kind": "float",
        "doc": "per-attempt distributed-init timeout seconds"},
    "LIGHTGBM_TPU_HOSTSYNC": {
        "default": "auto", "kind": "str",
        "doc": "host collective transport: auto/jax/tcp"},
    "LIGHTGBM_TPU_COMM_EXCHANGE": {
        "default": None, "kind": "flag",
        "doc": "force the two-phase comm exchange path"},
    "LIGHTGBM_TPU_DISABLE_PALLAS": {
        "default": "", "kind": "flag",
        "doc": "'1': never use the Pallas histogram kernel"},
    "LIGHTGBM_TPU_AUTO_PALLAS": {
        "default": None, "kind": "flag",
        "doc": "'1': let the cost model flip the Pallas kernel on"},
    "LIGHTGBM_TPU_DISABLE_SCAN": {
        "default": None, "kind": "flag",
        "doc": "'1': force per-iteration dispatch (no fused scan)"},
    "LIGHTGBM_TPU_AUTO_SCAN_ITERS": {
        "default": "", "kind": "spec",
        "doc": "override the fused-scan auto window, e.g. '8'"},
    "LIGHTGBM_TPU_FORCE_DONATE": {
        "default": None, "kind": "flag",
        "doc": "'1': keep donation declared even where the runtime "
               "would reject it (IR lint lowering)"},
    "LIGHTGBM_TPU_DEBUG_GATHER": {
        "default": None, "kind": "flag",
        "doc": "debug-check gather indices on host first"},
    "LIGHTGBM_TPU_BUILD_DIR": {
        "default": None, "kind": "path",
        "doc": "native extension build directory override"},
    "LIGHTGBM_TPU_NO_NATIVE": {
        "default": None, "kind": "flag",
        "doc": "non-empty: never load the native extension"},
}

# ---------------------------------------------------------------------
# 4. fault kinds
# ---------------------------------------------------------------------
# Injectable kinds (LIGHTGBM_TPU_FAULT_INJECT tokens). ``one_shot``
# kinds are stripped from the env var after a supervised restart
# (resilience/elastic.py): re-injecting a kill on every generation
# would restart-loop the world forever.

FAULT_KINDS = {
    "nan_grad": {
        "one_shot": False,
        "doc": "poison iteration N's gradients with NaN"},
    "nan_hess": {
        "one_shot": False,
        "doc": "poison iteration N's hessians with NaN"},
    "oom": {
        "one_shot": False,
        "doc": "synthetic RESOURCE_EXHAUSTED at iteration N"},
    "kill": {
        "one_shot": False,
        "doc": "SIGKILL this process at iteration N"},
    "rank_kill": {
        "one_shot": True,
        "doc": "SIGKILL the LIGHTGBM_TPU_FAULT_RANK rank(s) at "
               "iteration N (-1: during ingest)"},
    "stall_rank": {
        "one_shot": True,
        "doc": "infinite stall on the selected rank(s) at iteration "
               "N (watchdog fodder)"},
    "init_refuse": {
        "one_shot": False,
        "doc": "refuse N distributed-init connection attempts"},
    "publish_torn": {
        "one_shot": False,
        "doc": "leave a torn artifact on generation G's publish "
               "attempt"},
    "publish_poison": {
        "one_shot": False,
        "doc": "publish a sha-valid but canary-poisoned model"},
    "store_outage": {
        "one_shot": False,
        "doc": "artifact-store outage on generation G's publish "
               "attempt"},
    "serve_kill": {
        "one_shot": True,
        "doc": "SIGKILL the serve daemon at its N-th accepted "
               "request"},
    "refit_nan": {
        "one_shot": False,
        "doc": "poison tree T's gradients during Booster.refit"},
}

# Observed-only fault-EVENT kinds: never injectable, but emitted as
# ``{"event": "fault"}`` lines (and ``fault_events{kind}`` bumps) when
# the resilience layer trips on a real condition.

FAULT_EVENT_KINDS = {
    "nonfinite": {
        "doc": "the non-finite guard tripped on real grads/hessians"},
    "collective_timeout": {
        "doc": "a host collective missed the watchdog deadline"},
    "collective_error": {
        "doc": "a host collective raised (transport error)"},
    "swap_failure": {
        "doc": "a serve hot-swap failed; the old model keeps serving"},
    "canary_refused": {
        "doc": "the serve-side canary gate refused a publication"},
}

# ---------------------------------------------------------------------
# derived conveniences (NOT literal-evaled by the lint)
# ---------------------------------------------------------------------

EVENT_NAMES = frozenset(EVENTS)


def event_keys(name):
    """required + optional keys of one declared event."""
    spec = EVENTS[name]
    return tuple(spec["required"]) + tuple(spec["optional"])


def required_keys(name):
    return tuple(EVENTS[name]["required"])


def injectable_fault_kinds():
    """Declaration-ordered LIGHTGBM_TPU_FAULT_INJECT kinds."""
    return tuple(FAULT_KINDS)


def one_shot_fault_kinds():
    """Kinds stripped from the inject spec after a restart."""
    return tuple(k for k, spec in FAULT_KINDS.items()
                 if spec["one_shot"])


def fault_event_kinds():
    """Every legal ``{"event": "fault"}`` kind string."""
    return tuple(FAULT_KINDS) + tuple(FAULT_EVENT_KINDS)
