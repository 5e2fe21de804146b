"""Per-iteration JSONL telemetry events and the ``stats`` readers.

The counterpart of ``lightgbm_tpu/obs/recorder.py``. One
:class:`TelemetryRecorder` owns one output file and emits exactly one
``{"event": "iteration"}`` object per boosting iteration, with every
required key of ``schemas.EVENTS["iteration"]``:

- ``phases``: per-label wall-time deltas for the iteration, diffed from
  ``Timer.snapshot()`` (``utils/timer.py``; attaching enables the Timer,
  whose sections then end with a device synchronize, so each phase is
  the device's time too);
- ``hbm``: the training device's allocator gauges (``obs/memory.py``),
  nulls on the CPU;
- ``tree``: leaves grown and split-gain sum of the iteration's trees
  (``GBDTBooster.telemetry_tree_stats``);
- ``eval``: the evaluation tuples the train loop produced (if any);
- ``recompiles``, ``comm`` and ``scan``: the JAX package counts XLA
  recompiles, collective payloads and fused scan windows there. One
  card running eager PyTorch has no jit cache, no collective and no
  fused scan, so they carry what the JAX package writes when there are
  none: ``{"delta": 0, "total": 0}``, null and null.

Fault events (the engine's ``fault_log`` and the process-level log of
``resilience/faults.py``) and span events (``obs/trace.py``) are drained
into the stream ahead of their iteration's line. The recorder is inert
until ``attach()``: no file is opened, the Timer stays untouched, and a
disabled run writes zero bytes. Everything it measures also feeds the
global :class:`~lightgbm_tpu_torch.obs.registry.MetricsRegistry`.

The summary side (``summarize_events``, ``render_stats_table``,
``summarize_directory`` and the fleet merge) is the JAX package's,
copied: it reads the events of both packages.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Dict, List, Optional, Sequence, Tuple

from .memory import device_memory_stats
from .registry import MetricsRegistry
from .registry import registry as _global_registry
from .schemas import EVENT_NAMES, required_keys

__all__ = ["TelemetryRecorder", "ITERATION_EVENT_KEYS",
           "UnknownEventError",
           "summarize_events", "render_stats_table", "ENTRY_PHASES",
           "summarize_directory", "merge_fleet_summaries",
           "render_fleet_table"]

#: required keys of every iteration event (obs/schemas.py EVENTS)
ITERATION_EVENT_KEYS = required_keys("iteration")

#: the ``recompiles`` value of an iteration that recompiled nothing
_NO_RECOMPILES = {"delta": 0, "total": 0}


class UnknownEventError(ValueError):
    """A telemetry stream carried an event name the schema registry
    (obs/schemas.py EVENTS) does not declare — a corrupt or
    foreign-version stream. Raised by :func:`summarize_events` instead
    of silently skipping the line (a truncated FINAL line is still
    tolerated at the JSON-parse level, like every stream reader)."""

    def __init__(self, name: str, path: str = ""):
        self.event_name = name
        where = f" in {path}" if path else ""
        super().__init__(
            f"undeclared telemetry event {name!r}{where} — not in the "
            f"obs/schemas.py EVENTS registry")


class TelemetryRecorder:
    """Streams one JSONL event per boosting iteration to ``path``."""

    def __init__(self, path: str,
                 registry: Optional[MetricsRegistry] = None):
        self.path = str(path)
        self.registry = registry if registry is not None \
            else _global_registry
        self._file = None
        self._started = False
        self._engines: List = []
        self._phase_base: Dict[str, Dict[str, float]] = {}
        self._prev_timer_enabled: Optional[bool] = None
        self._t0 = 0.0
        self._last_iter_mono = 0.0
        self.events_written = 0

    # -- lifecycle -----------------------------------------------------
    @property
    def active(self) -> bool:
        return self._started

    def attach(self, model) -> None:
        """Bind to a Booster / CVBooster and start recording. Idempotent
        per recorder; a recorder reused across train() calls keeps
        appending to the same file."""
        engines = []
        for booster in getattr(model, "boosters", None) or [model]:
            eng = getattr(booster, "_engine", None)
            if eng is not None and eng not in engines:
                engines.append(eng)
        self._engines = engines
        if self._started:
            self._record_ingest()
            return
        from ..utils.timer import Timer
        self._prev_timer_enabled = Timer.enabled()
        Timer.enable()
        self._phase_base = Timer.snapshot()
        self._t0 = time.perf_counter()
        self._last_iter_mono = self._t0
        self._started = True
        # telemetry must degrade, never break training: an unwritable
        # path downgrades to registry-only recording; in a world, rank 0
        # writes for every rank
        from ..parallel.mesh import world_rank
        if world_rank() != 0:
            self._file = None
            self._record_ingest()
            return
        try:
            dirname = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(dirname, exist_ok=True)
            self._file = open(self.path, "a", encoding="utf-8")
        except OSError as e:
            from ..log import log_warning
            log_warning(f"telemetry: cannot open {self.path!r} "
                        f"({e}); events will not be written")
            self._file = None
        self._record_ingest()

    def _record_ingest(self) -> None:
        """One ``{"event": "ingest"}`` line per streamed training set
        (``data/``): construction ran before the recorder attached.
        Recorded at most once per Dataset."""
        if self._file is None:
            return
        for eng in self._engines:
            ts = getattr(eng, "train_set", None)
            stats = getattr(ts, "_ingest_stats", None)
            if stats is None or getattr(ts, "_ingest_recorded", False):
                continue
            ts._ingest_recorded = True
            self._write_line({"event": "ingest", **stats})

    def close(self) -> None:
        """Drain the fault, compile and span events still queued (a raise unwinds
        before the next ``record_iteration``, and its fault line must
        not be lost with it), close the file and restore the Timer. Every
        step runs under ``finally``."""
        try:
            self._drain_fault_events()
            self._drain_compile_events()
            self._drain_span_events()
        finally:
            try:
                if self._file is not None:
                    try:
                        self._file.close()
                    except OSError:
                        pass
                    self._file = None
            finally:
                if self._prev_timer_enabled is not None:
                    from ..utils.timer import Timer
                    Timer.enable(self._prev_timer_enabled)
                    self._prev_timer_enabled = None
                self._started = False
                self._engines = []

    # -- event assembly ------------------------------------------------
    def _phase_delta(self, keep_all: bool = False
                     ) -> Dict[str, Dict[str, float]]:
        """Per-iteration diff of ``Timer.snapshot()`` (``keep_all``: every
        label, idle ones too, so the ranks of a world hold the same
        set)."""
        from ..utils.timer import Timer
        snap = Timer.snapshot()
        delta: Dict[str, Dict[str, float]] = {}
        for label, cur in snap.items():
            base = self._phase_base.get(label, {"total": 0.0, "count": 0})
            dt = cur["total"] - base["total"]
            dc = int(cur["count"] - base["count"])
            if dc > 0 or dt > 0 or keep_all:
                delta[label] = {"total": dt, "count": dc}
        self._phase_base = snap
        return delta

    def _comm_stats(self, tree: Dict) -> Optional[Dict[str, object]]:
        """The iteration's collective payloads from the first engine in a
        world (``models/gbdt.py`` ``telemetry_comm_stats``); None on one
        card."""
        leaves = tree.get("leaves") if len(self._engines) == 1 else None
        for eng in self._engines:
            stats = eng.telemetry_comm_stats(leaves)
            if stats is not None:
                return stats
        return None

    def _tree_stats(self) -> Dict[str, Optional[float]]:
        leaves = 0
        gain = 0.0
        trees = 0
        for eng in self._engines:
            stats = eng.telemetry_tree_stats()
            if stats is None:
                continue
            trees += stats["trees"]
            leaves += stats["leaves"]
            gain += stats["split_gain_sum"]
        if trees == 0:
            return {"trees": 0, "leaves": None, "split_gain_sum": None}
        return {"trees": trees, "leaves": leaves, "split_gain_sum": gain}

    @staticmethod
    def _eval_dict(evals: Optional[Sequence]) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for entry in evals or []:
            try:
                out[f"{entry[0]}:{entry[1]}"] = float(entry[2])
            except (TypeError, ValueError, IndexError):
                continue
        return out

    def _write_line(self, obj: dict) -> None:
        """One JSONL line; an OSError (ENOSPC etc.) degrades to
        registry-only recording instead of breaking training."""
        if self._file is None:
            return
        try:
            self._file.write(json.dumps(obj) + "\n")
            self._file.flush()
        except OSError as e:
            from ..log import log_warning
            log_warning(f"telemetry: write to {self.path!r} failed "
                        f"({e}); stopping the event stream")
            try:
                self._file.close()
            except OSError:
                pass
            self._file = None

    def _drain_compile_events(self) -> None:
        """Move pending cost-attribution records (obs/cost.py: one per
        entry point and new call signature) into the stream, through the
        same locked snapshot-and-clear as fault events."""
        from .cost import drain_compile_events
        for ev in drain_compile_events():
            self._write_line(ev)

    def _drain_span_events(self) -> None:
        """Move pending trace spans (obs/trace.py) into the stream."""
        from .trace import drain_span_events
        for ev in drain_span_events():
            self._write_line(ev)

    def _drain_fault_events(self) -> None:
        """Move fault events (the engines' ``fault_log``: guard trips,
        OOM rungs; and the process-level ``resilience.faults.FAULT_EVENTS``)
        into the stream through the locked snapshot-and-clear, so an
        event appended from another thread is never lost."""
        from ..resilience.faults import FAULT_EVENTS, drain_events
        for eng in self._engines:
            log = getattr(eng, "fault_log", None)
            if not log:
                continue
            for ev in drain_events(log):
                self._write_line(ev)
        if FAULT_EVENTS:
            for ev in drain_events(FAULT_EVENTS):
                self._write_line(ev)

    def record_iteration(self, iteration: int,
                         evals: Optional[Sequence] = None) -> dict:
        """Assemble, register and write the event for one iteration."""
        if not self.active:
            return {}
        from ..parallel.mesh import world_size
        multiproc = world_size() > 1
        if multiproc and self._engines:
            # the event is a sync point of the world already: the ranks'
            # step check rides along, then the phases' skew across ranks
            from ..parallel.spmd import verify_step_consistency
            verify_step_consistency(int(iteration),
                                    len(self._engines[0].models))
        phases = self._phase_delta(keep_all=multiproc)
        if multiproc:
            from ..parallel.spmd import aggregate_phase_snapshot
            phases = aggregate_phase_snapshot(phases)
        device = self._engines[0].device if self._engines else None
        tree = self._tree_stats()
        now_mono = time.perf_counter()
        event = {
            "event": "iteration",
            "iteration": int(iteration),
            "wall_time": now_mono - self._t0,
            "phases": phases,
            "recompiles": dict(_NO_RECOMPILES),
            "hbm": device_memory_stats(device),
            "tree": tree,
            "eval": self._eval_dict(evals),
            "comm": self._comm_stats(tree),
            "scan": None,
        }
        self._feed_registry(event)
        # the iteration's trace spans (train/iteration parent + phase
        # children) from the deltas just computed
        from .trace import record_iteration_spans
        record_iteration_spans(event, self._last_iter_mono, now_mono)
        self._last_iter_mono = now_mono
        self._drain_fault_events()   # fault lines precede their iteration
        self._drain_compile_events()  # so do the signatures it ran
        self._drain_span_events()    # and the spans it was timed by
        self._write_line(event)
        self.events_written += 1
        return event

    def _feed_registry(self, event: dict) -> None:
        reg = self.registry
        reg.counter("iterations").inc()
        reg.counter("jit_recompiles").inc(event["recompiles"]["delta"])
        for label, v in event["phases"].items():
            # a world's phases carry the ranks' mean (and min/max)
            reg.histogram("phase_seconds", phase=label).observe(
                v.get("total", v.get("mean", 0.0)))
        for key in ("bytes_in_use", "peak_bytes_in_use"):
            if event["hbm"].get(key) is not None:
                reg.gauge(f"hbm_{key}").set(event["hbm"][key])
        if event["tree"]["leaves"] is not None:
            reg.histogram("tree_leaves").observe(event["tree"]["leaves"])
            reg.histogram("tree_split_gain_sum").observe(
                event["tree"]["split_gain_sum"])
        comm = event.get("comm")
        if comm:
            reg.counter("comm_bytes", mode=str(comm["parallel_mode"]),
                        wire=str(comm["hist_comm"])).inc(
                comm["payload_bytes"])


# ---------------------------------------------------------------------
# summary side: `python -m lightgbm_tpu_torch stats <file.jsonl>`, a
# copy of the JAX package's readers (either package reads either stream)
# ---------------------------------------------------------------------

def _stream_lines(path: str, parse):
    """Yield ``parse(line, is_last)`` over non-empty lines with one
    line of lookahead, skipping None results — O(1) memory."""
    with open(path, encoding="utf-8") as fh:
        pending: Optional[str] = None
        for raw in fh:
            line = raw.strip()
            if not line:
                continue
            if pending is not None:
                ev = parse(pending, False)
                if ev is not None:
                    yield ev
            pending = line
        if pending is not None:
            ev = parse(pending, True)
            if ev is not None:
                yield ev


def summarize_events(path: str) -> dict:
    """Fold a telemetry JSONL file into one summary dict.

    A truncated FINAL line is tolerated (skipped with a warning): a
    ``SIGKILL``/preemption can land mid-write, and the stream up to
    that point is exactly what a post-mortem needs. Garbage anywhere
    *before* the last line still raises — that is corruption, not a
    crash artifact."""
    iters = 0
    phases: Dict[str, Dict[str, float]] = {}
    recompiles = 0
    peak_hbm: Optional[int] = None
    leaves = 0
    gain = 0.0
    wall = 0.0
    last_eval: Dict[str, float] = {}
    faults: Dict[str, int] = {}
    ingest: Optional[Dict[str, float]] = None
    serve: Optional[Dict[str, object]] = None
    serve_events = 0
    publishes = 0
    publish: Optional[Dict[str, object]] = None
    comm_bytes = 0
    comm_post_bytes = 0
    comm_last: Optional[Dict[str, object]] = None
    scan_windows = 0
    scan_iterations = 0
    compiles: Dict[str, Dict[str, object]] = {}
    fleet_events = 0
    fleet: Optional[Dict[str, object]] = None
    autoscale: Dict[str, int] = {}
    autoscale_last: Optional[Dict[str, object]] = None
    rollbacks = 0
    rollback_last: Optional[Dict[str, object]] = None
    spans = 0

    def _parse(line: str, is_last: bool) -> Optional[dict]:
        try:
            ev = json.loads(line)
        except ValueError:
            if is_last:
                from ..log import log_warning
                log_warning(
                    f"telemetry: ignoring truncated final line in "
                    f"{path} (the writer was killed mid-write)")
                return None
            raise
        if not isinstance(ev, dict):
            raise ValueError(
                f"telemetry line is not a JSON object: {line[:80]!r}")
        return ev

    # streamed with one line of lookahead (telemetry files can be
    # hundreds of MB): a line is final — and thus allowed to be a
    # truncated crash artifact — only when nothing non-empty follows
    events = _stream_lines(path, _parse)
    for ev in events:
        name = ev.get("event")
        if not isinstance(name, str) or name not in EVENT_NAMES:
            # an undeclared event name means a corrupt or
            # foreign-version stream, not a crash artifact — refuse
            # loudly instead of silently skipping (a truncated FINAL
            # line was already handled above, at the JSON level)
            raise UnknownEventError(str(name), path)
        if ev.get("event") == "fault":
            kind = str(ev.get("kind", "unknown"))
            faults[kind] = faults.get(kind, 0) + 1
            continue
        if ev.get("event") == "ingest":
            ingest = {k: v for k, v in ev.items() if k != "event"}
            continue
        if ev.get("event") == "serve":
            # serve lines carry cumulative counters; the newest one IS
            # the summary (plus how many intervals were recorded)
            serve_events += 1
            serve = {k: v for k, v in ev.items() if k != "event"}
            continue
        if ev.get("event") == "publish":
            # one line per atomic model publication
            # (resilience/publisher.py; docs/PIPELINE.md)
            publishes += 1
            publish = {k: v for k, v in ev.items() if k != "event"}
            continue
        if ev.get("event") == "compile":
            # XLA cost attribution (obs/cost.py): fold per entry point
            # — totals accumulate, the cost-model numbers keep the
            # newest signature's values (re-compiles of one entry are
            # usually shape growth, and the latest shape is the one
            # the phase table measured)
            entry = str(ev.get("entry", "?"))
            slot = compiles.setdefault(
                entry, {"compiles": 0, "wall_ms_total": 0.0,
                        "flops": None, "bytes_accessed": None,
                        "optimal_ms": None, "device_kind": None})
            slot["compiles"] += int(ev.get("compiles", 1) or 1)
            slot["wall_ms_total"] += float(ev.get("wall_ms") or 0.0)
            for key in ("flops", "bytes_accessed", "optimal_ms",
                        "device_kind"):
                if ev.get(key) is not None:
                    slot[key] = ev[key]
            continue
        if ev.get("event") == "fleet":
            # fleet scrape lines carry the supervisor's whole view;
            # the newest one IS the summary
            fleet_events += 1
            fleet = {k: v for k, v in ev.items() if k != "event"}
            continue
        if ev.get("event") == "autoscale":
            # one line per scaling action (resilience/elastic.py):
            # counted per direction, newest kept for provenance
            action = str(ev.get("action", "?"))
            autoscale[action] = autoscale.get(action, 0) + 1
            autoscale_last = {k: v for k, v in ev.items()
                              if k != "event"}
            continue
        if ev.get("event") == "rollback":
            # one line per publication rollback ordered by the fleet
            # supervisor's canary/health guard (docs/RESILIENCE.md)
            rollbacks += 1
            rollback_last = {k: v for k, v in ev.items()
                             if k != "event"}
            continue
        if ev.get("event") == "span":
            # trace spans are counted here and analyzed by the
            # `trace <dir>` subcommand (obs/trace.py)
            spans += 1
            continue
        if ev.get("event") != "iteration":
            continue
        iters += 1
        wall = max(wall, float(ev.get("wall_time", 0.0)))
        for label, v in ev.get("phases", {}).items():
            slot = phases.setdefault(
                label, {"total": 0.0, "count": 0,
                        "max_skew": 0.0})
            # single-process events carry total; SPMD-aggregated
            # ones carry mean (per-process) + min/max
            slot["total"] += float(v.get("total", v.get("mean", 0.0)))
            slot["count"] += int(v.get("count", 0))
            if "max" in v and "min" in v:
                slot["max_skew"] = max(
                    slot["max_skew"],
                    float(v["max"]) - float(v["min"]))
        recompiles += int(ev.get("recompiles", {}).get("delta", 0))
        hbm = ev.get("hbm", {})
        for key in ("peak_bytes_in_use", "bytes_in_use"):
            if hbm.get(key) is not None:
                peak_hbm = max(peak_hbm or 0, int(hbm[key]))
                break
        tree = ev.get("tree", {})
        if tree.get("leaves") is not None:
            leaves += int(tree["leaves"])
            gain += float(tree.get("split_gain_sum") or 0.0)
        if ev.get("eval"):
            last_eval = ev["eval"]
        if ev.get("comm"):
            comm_last = ev["comm"]
            comm_bytes += int(ev["comm"].get("payload_bytes", 0))
            comm_post_bytes += int(ev["comm"].get(
                "post_reduction_bytes",
                ev["comm"].get("payload_bytes", 0)))
        if ev.get("scan"):
            scan_iterations += 1
            if ev["scan"].get("dispatch"):
                scan_windows += 1
    return {"iterations": iters, "wall_time": wall, "phases": phases,
            "recompiles": recompiles, "peak_hbm_bytes": peak_hbm,
            "total_leaves": leaves, "total_split_gain": gain,
            "last_eval": last_eval, "faults": faults, "ingest": ingest,
            "serve": serve, "serve_events": serve_events,
            "publishes": publishes, "publish": publish,
            "comm_bytes": comm_bytes,
            "comm_post_reduction_bytes": comm_post_bytes,
            "comm": comm_last,
            "scan_windows": scan_windows,
            "scan_iterations": scan_iterations,
            "compiles": compiles,
            "fleet": fleet, "fleet_events": fleet_events,
            "autoscale": autoscale, "autoscale_last": autoscale_last,
            "rollbacks": rollbacks, "rollback": rollback_last,
            "spans": spans}


#: entry point -> the port's Timer phase (``utils/timer.py``) whose
#: per-call mean is the measured counterpart of the entry's optimal ms.
#: Entries without a phase (the kernels, the predict paths) still list
#: their cost numbers, just without a measured column.
ENTRY_PHASES = {
    "ops/grow_tree": "tree_learner/grow",
    "parallel/dp_grow": "tree_learner/grow",
    "ranking/lambdarank_grads": "boosting/gradients",
}


def _render_compiles(summary: dict, lines: list) -> None:
    """The ``xla cost`` section: per-entry flops/bytes from the compile
    events plus the roofline comparison — measured per-call phase ms
    against the cost-model optimal at the device peaks."""
    compiles = summary.get("compiles")
    if not compiles:
        return
    phases = summary.get("phases") or {}
    kinds = {v.get("device_kind") for v in compiles.values()
             if v.get("device_kind")}
    lines.append("")
    lines.append(f"xla cost attribution"
                 f"{' (' + ', '.join(sorted(kinds)) + ')' if kinds else ''}:")
    lines.append(f"{'entry':28s} {'compiles':>8s} {'GFLOP':>9s} "
                 f"{'MiB acc':>9s} {'compile ms':>11s} {'opt ms':>8s} "
                 f"{'meas ms':>8s} {'roofline':>9s}")
    for entry, v in sorted(compiles.items()):
        flops = v.get("flops")
        nbytes = v.get("bytes_accessed")
        opt = v.get("optimal_ms")
        meas = None
        phase = phases.get(ENTRY_PHASES.get(entry, ""))
        if phase and phase.get("count"):
            meas = phase["total"] / phase["count"] * 1e3
        roof = (f"{100.0 * opt / meas:8.1f}%"
                if opt is not None and meas else "      n/a")
        lines.append(
            f"{entry:28s} {v.get('compiles', 0):8d} "
            f"{'n/a' if flops is None else '%.3f' % (flops / 1e9):>9s} "
            f"{'n/a' if nbytes is None else '%.1f' % (nbytes / 2**20):>9s} "
            f"{v.get('wall_ms_total', 0.0):11.1f} "
            f"{'n/a' if opt is None else '%.3f' % opt:>8s} "
            f"{'n/a' if meas is None else '%.3f' % meas:>8s} "
            f"{roof}")


def render_stats_table(summary: dict) -> str:
    """The sorted human-readable table behind ``stats``."""
    lines = []
    lines.append(f"iterations           : {summary['iterations']}")
    lines.append(f"wall time            : {summary['wall_time']:.3f} s")
    lines.append(f"jit recompiles       : {summary['recompiles']}")
    hbm = summary["peak_hbm_bytes"]
    lines.append("peak HBM             : " +
                 (f"{hbm / 2**20:.1f} MiB" if hbm is not None else "n/a"))
    ing = summary.get("ingest")
    if ing:
        lines.append(
            f"ingest               : {ing.get('rows', 0)} rows / "
            f"{ing.get('chunks', 0)} chunks of "
            f"{ing.get('chunk_rows', 0)} "
            f"(pass1 {ing.get('pass1_s', 0.0):.3f} s, "
            f"pass2 {ing.get('pass2_s', 0.0):.3f} s)")
    srv = summary.get("serve")
    if srv:
        p50 = srv.get("p50_ms")
        p99 = srv.get("p99_ms")
        rc = srv.get("recompiles") or {}
        lines.append(
            f"serve                : {srv.get('requests_total', 0)} req"
            f" / {srv.get('rows_total', 0)} rows in "
            f"{summary.get('serve_events', 0)} interval(s), last qps "
            f"{srv.get('qps', 0):g}, p50 "
            f"{'n/a' if p50 is None else '%g ms' % p50}, p99 "
            f"{'n/a' if p99 is None else '%g ms' % p99}, swaps "
            f"{srv.get('swaps_total', 0)}, shed "
            f"{srv.get('shed_total', 0)}, recompiles "
            f"{rc.get('total', 0)}, model {srv.get('model', '?')}")
    pub = summary.get("publish")
    if pub:
        sha = str(pub.get("sha256") or "?")
        lines.append(
            f"publish              : {summary.get('publishes', 0)} "
            f"publication(s), last {pub.get('file', '?')} "
            f"(gen {pub.get('generation', '?')}, "
            f"train_auc {pub.get('train_auc', '?')}, "
            f"sha256 {sha[:12]}…)")
    comm = summary.get("comm")
    if comm:
        cb = summary.get("comm_bytes", 0)
        pb = summary.get("comm_post_reduction_bytes", cb)
        lines.append(
            f"comm payload         : {cb / 2**20:.1f} MiB modeled "
            f"({comm.get('parallel_mode', '?')}-parallel, "
            f"hist_comm {comm.get('hist_comm', '?')}, "
            f"{comm.get('split_search', 'gathered')} search, world "
            f"{comm.get('world', '?')}; post-reduction "
            f"{pb / 2**20:.1f} MiB)")
    flt = summary.get("fleet")
    if flt:
        replicas = flt.get("replicas") or flt.get("ranks") or []
        alive = sum(1 for r in replicas if r.get("alive", True))
        extras = ""
        if flt.get("restarts_total") is not None:
            extras += f", restarts {flt['restarts_total']}"
        if flt.get("iteration_skew") is not None:
            extras += f", iter skew {flt['iteration_skew']}"
        lines.append(
            f"fleet                : {alive}/{len(replicas)} "
            f"{flt.get('shape', 'replicas')} up in "
            f"{summary.get('fleet_events', 0)} scrape(s){extras}")
    asc = summary.get("autoscale") or {}
    if asc:
        lines.append(
            f"autoscale            : {asc.get('up', 0)} up / "
            f"{asc.get('down', 0)} down")
    if summary.get("rollbacks"):
        rb = summary.get("rollback") or {}
        bad = str(rb.get("bad_sha") or "?")[:12]
        good = str(rb.get("good_sha") or "?")[:12]
        lines.append(
            f"rollbacks            : {summary['rollbacks']} "
            f"(last: bad {bad} -> good {good})")
    if summary.get("scan_windows"):
        lines.append(
            f"fused scan           : {summary['scan_iterations']} "
            f"iterations in {summary['scan_windows']} window(s) "
            f"(~{summary['scan_iterations'] / summary['scan_windows']:.1f}"
            " iters/dispatch)")
    lines.append(f"leaves grown         : {summary['total_leaves']}")
    lines.append(f"split gain sum       : {summary['total_split_gain']:g}")
    faults = summary.get("faults") or {}
    if faults:
        per_kind = ", ".join(f"{k}={v}" for k, v in sorted(faults.items()))
        lines.append(f"fault events         : {sum(faults.values())} "
                     f"({per_kind})")
    if summary.get("spans"):
        lines.append(f"trace spans          : {summary['spans']} "
                     "(merge: python -m lightgbm_tpu trace <dir>)")
    for key, val in sorted(summary["last_eval"].items()):
        lines.append(f"final {key:15s}: {val:g}")
    phases = summary["phases"]
    if phases:
        grand = sum(v["total"] for v in phases.values()) or 1.0
        lines.append("")
        lines.append(f"{'phase':34s} {'total s':>10s} {'count':>8s} "
                     f"{'mean ms':>10s} {'%':>6s} {'skew s':>8s}")
        for label, v in sorted(phases.items(),
                               key=lambda kv: -kv[1]["total"]):
            cnt = int(v["count"])
            mean_ms = v["total"] / cnt * 1e3 if cnt else 0.0
            lines.append(
                f"{label:34s} {v['total']:10.3f} {cnt:8d} "
                f"{mean_ms:10.3f} {100 * v['total'] / grand:6.1f} "
                f"{v['max_skew']:8.3f}")
    _render_compiles(summary, lines)
    return "\n".join(lines)


# ---------------------------------------------------------------------
# fleet side: a DIRECTORY of telemetry files (one per process) and the
# merged cross-process view behind `stats <dir> --fleet`
# ---------------------------------------------------------------------

#: the stream names the fleet writes: ``x.jsonl`` plus the
#: per-replica ``x.jsonl.rankN`` and supervisor ``x.jsonl.fleet``
#: suffixes — and nothing else, so a rotated ``x.jsonl.gz`` or an
#: editor's ``x.jsonl.swp`` can never abort the whole directory walk
_STREAM_NAME_RE = re.compile(r"\.jsonl(\.rank\d+|\.fleet)?$")


def summarize_directory(directory: str) -> List[Tuple[str, dict]]:
    """``summarize_events`` over every telemetry stream under
    ``directory`` (recursive — the pipeline nests telemetry/ per
    side), sorted by relative path for stable provenance. Files whose
    events are all unknown kinds still appear (an empty summary keeps
    the provenance honest); matched-but-unreadable files raise like
    the single-file path."""
    out: List[Tuple[str, dict]] = []
    for root, _dirs, names in sorted(os.walk(directory)):
        for name in sorted(names):
            if not _STREAM_NAME_RE.search(name):
                continue
            path = os.path.join(root, name)
            rel = os.path.relpath(path, directory)
            out.append((rel, summarize_events(path)))
    return out


def merge_fleet_summaries(entries: List[Tuple[str, dict]]) -> dict:
    """Fold per-process summaries into one fleet view: trainer
    iteration/compile totals, summed serve traffic with worst-case
    p99, shed and restart totals — the numbers ROADMAP 3(b)'s
    autoscaler decides on."""
    merged = {
        "files": len(entries),
        "iterations": 0, "recompiles": 0, "compile_ms": 0.0,
        "publishes": 0, "faults": 0,
        "serve_replicas": 0, "requests_total": 0, "rows_total": 0,
        "shed_total": 0, "swaps_total": 0,
        "qps": 0.0, "p99_ms_max": None,
        "restarts_total": 0, "iteration_skew": None,
        "scale_ups": 0, "scale_downs": 0, "rollbacks": 0,
    }
    for _rel, s in entries:
        merged["iterations"] += int(s.get("iterations") or 0)
        merged["recompiles"] += int(s.get("recompiles") or 0)
        for v in (s.get("compiles") or {}).values():
            merged["compile_ms"] += float(v.get("wall_ms_total") or 0)
        merged["publishes"] += int(s.get("publishes") or 0)
        merged["faults"] += sum((s.get("faults") or {}).values())
        srv = s.get("serve")
        if srv:
            merged["serve_replicas"] += 1
            merged["requests_total"] += int(
                srv.get("requests_total") or 0)
            merged["rows_total"] += int(srv.get("rows_total") or 0)
            merged["shed_total"] += int(srv.get("shed_total") or 0)
            merged["swaps_total"] += int(srv.get("swaps_total") or 0)
            merged["qps"] += float(srv.get("qps") or 0.0)
            p99 = srv.get("p99_ms")
            if p99 is not None:
                merged["p99_ms_max"] = max(
                    merged["p99_ms_max"] or 0.0, float(p99))
        flt = s.get("fleet")
        if flt:
            if flt.get("restarts_total") is not None:
                merged["restarts_total"] = max(
                    merged["restarts_total"],
                    int(flt["restarts_total"]))
            if flt.get("iteration_skew") is not None:
                merged["iteration_skew"] = max(
                    merged["iteration_skew"] or 0,
                    int(flt["iteration_skew"]))
        asc = s.get("autoscale") or {}
        merged["scale_ups"] += int(asc.get("up") or 0)
        merged["scale_downs"] += int(asc.get("down") or 0)
        merged["rollbacks"] += int(s.get("rollbacks") or 0)
    return merged


def render_fleet_table(merged: dict) -> str:
    lines = ["fleet (merged view)"]
    lines.append(f"files                : {merged['files']}")
    lines.append(f"iterations           : {merged['iterations']}")
    lines.append(f"jit recompiles       : {merged['recompiles']}")
    if merged["compile_ms"]:
        lines.append(f"compile wall         : "
                     f"{merged['compile_ms'] / 1e3:.3f} s")
    lines.append(f"publishes            : {merged['publishes']}")
    if merged["serve_replicas"]:
        p99 = merged["p99_ms_max"]
        lines.append(
            f"serve fleet          : {merged['serve_replicas']} "
            f"replica(s), {merged['requests_total']} req / "
            f"{merged['rows_total']} rows, qps {merged['qps']:g}, "
            f"worst p99 {'n/a' if p99 is None else '%g ms' % p99}, "
            f"shed {merged['shed_total']}, swaps "
            f"{merged['swaps_total']}")
    if merged.get("scale_ups") or merged.get("scale_downs"):
        lines.append(
            f"autoscale            : {merged['scale_ups']} up / "
            f"{merged['scale_downs']} down")
    if merged.get("rollbacks"):
        lines.append(f"rollbacks            : {merged['rollbacks']}")
    extras = []
    if merged["restarts_total"]:
        extras.append(f"restarts {merged['restarts_total']}")
    if merged["iteration_skew"] is not None:
        extras.append(f"iteration skew {merged['iteration_skew']}")
    if merged["faults"]:
        extras.append(f"faults {merged['faults']}")
    if extras:
        lines.append(f"health               : {', '.join(extras)}")
    return "\n".join(lines)
