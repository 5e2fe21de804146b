"""Spans and the ``trace`` reader: a copy of ``lightgbm_tpu/obs/trace.py``.

One span is one named, timed section — in the port, a boosting
iteration (``train/iteration``) and its Timer phases (``phase/<label>``),
derived per iteration by the telemetry recorder from the phase deltas
it already computed — emitted as ``{"event": "span"}`` JSONL lines
through the recorder's drain.

- ``trace_id`` groups spans into one causal story; ``span_id`` names
  the span; ``parent_id`` is the causing span (or null for roots).
- Every span carries a PAIRED wall clock (``wall``, ``time.time`` at
  span start) and monotonic clock (``mono``, ``time.perf_counter`` at
  span start) plus ``dur`` seconds. The ``trace`` CLI estimates each
  process's offset (median of ``wall - mono`` over its spans) and
  places all processes on ONE corrected timeline.
- Context propagates through the ``LIGHTGBM_TPU_TRACE_CTX`` env var
  (``trace_id:span_id``) into spawned workers.

``python -m lightgbm_tpu_torch trace <dir>`` merges every stream under a
directory, writes Chrome trace-event JSON (Perfetto-loadable) and
prints the lifecycle critical paths (last iteration -> publish -> swap
-> first request) of streams that hold publish and swap spans; the
JAX package's pipeline writes those, and either package reads them.

The span buffer is appended from trainer threads and drained from the
recorder: every touch of ``_spans`` and the current trace context goes
through ``_spans_lock``. This module imports neither torch nor numpy.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import sys
import threading
import time
import uuid
from collections import defaultdict
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional, Tuple

__all__ = ["SPAN_EVENT_KEYS", "FUSED_SCAN_PHASE", "BLOCKING_PHASES",
           "TRACE_CTX_ENV", "new_trace_id", "new_span_id",
           "make_span", "record_span", "span", "drain_span_events",
           "span_events_snapshot", "current_context",
           "set_current_trace", "format_context",
           "record_iteration_spans", "load_spans",
           "correct_clock_skew", "chrome_trace", "critical_paths",
           "render_critical_paths", "main"]

#: the JSONL keys of every ``{"event": "span"}`` line (obs/schemas.py
#: EVENTS)
from .schemas import required_keys as _required_keys  # noqa: E402

SPAN_EVENT_KEYS = _required_keys("span")

#: the JAX package's Timer phase that blocks inside a fused-scan
#: window; a stream of its with ``scan`` iterations gets the host-gap
#: decomposition below (the port writes ``scan: null``)
FUSED_SCAN_PHASE = "boosting/fused_scan"
BLOCKING_PHASES = (FUSED_SCAN_PHASE,)

#: env var carrying the current trace context into spawned workers
#: (``trace_id:span_id``)
TRACE_CTX_ENV = "LIGHTGBM_TPU_TRACE_CTX"

#: span-buffer cap: a consumer that never drains must not grow memory
#: forever (appends beyond the cap are dropped, drains restart it)
_SPANS_CAP = 4096

_spans_lock = threading.Lock()
# ---- guarded by _spans_lock ----
_spans: List[Dict[str, Any]] = []
_spans_dropped = 0
# (trace_id, span_id) of the process-current trace; False = env not
# parsed yet, None = parsed and absent
_current: Any = False


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


def _proc_label() -> str:
    # derived per span, not cached: spans land per iteration (never
    # per row), and a cache would be one more thread-shared field
    rank = os.environ.get("LIGHTGBM_TPU_RANK") or ""
    return f"pid{os.getpid()}" + (f".rank{rank}" if rank else "")


def format_context(trace_id: str, span_id: str) -> str:
    """The ``LIGHTGBM_TPU_TRACE_CTX`` wire form."""
    return f"{trace_id}:{span_id}"


def _parse_context(raw: str) -> Optional[Tuple[str, str]]:
    parts = (raw or "").split(":")
    if len(parts) == 2 and all(parts):
        return (parts[0], parts[1])
    return None


def current_context() -> Optional[Dict[str, str]]:
    """The process-current trace context (``{"trace_id", "span_id"}``)
    — set explicitly via :func:`set_current_trace` or inherited from
    the ``LIGHTGBM_TPU_TRACE_CTX`` env var on first use; None when
    neither exists."""
    global _current
    with _spans_lock:
        if _current is False:
            _current = _parse_context(
                os.environ.get(TRACE_CTX_ENV, ""))
        ctx = _current
    if ctx is None:
        return None
    return {"trace_id": ctx[0], "span_id": ctx[1]}


def set_current_trace(trace_id: Optional[str],
                      span_id: Optional[str] = None) -> None:
    """Set (or with ``None`` clear) the process-current trace."""
    global _current
    with _spans_lock:
        _current = None if trace_id is None \
            else (trace_id, span_id or new_span_id())


def make_span(name: str, t_start: float,
              t_end: Optional[float] = None, *,
              trace_id: Optional[str] = None,
              span_id: Optional[str] = None,
              parent_id: Optional[str] = None,
              attrs: Optional[Dict[str, Any]] = None
              ) -> Dict[str, Any]:
    """Build one span event dict WITHOUT buffering it.

    ``t_start``/``t_end`` are ``time.perf_counter()`` readings;
    ``t_end`` defaults to now. The paired wall timestamp is derived
    from the current clock pair so spans whose start lies in the past
    still carry a consistent (wall, mono) anchor."""
    now_m = time.perf_counter()
    if t_end is None:
        t_end = now_m
    return {
        "event": "span",
        "name": str(name),
        "trace_id": trace_id or new_trace_id(),
        "span_id": span_id or new_span_id(),
        "parent_id": parent_id,
        "wall": time.time() - (now_m - t_start),
        "mono": float(t_start),
        "dur": max(0.0, float(t_end) - float(t_start)),
        "proc": _proc_label(),
        "attrs": dict(attrs) if attrs else {},
    }


def record_span(name: str, t_start: float,
                t_end: Optional[float] = None, *,
                trace_id: Optional[str] = None,
                span_id: Optional[str] = None,
                parent_id: Optional[str] = None,
                attrs: Optional[Dict[str, Any]] = None) -> str:
    """Record one finished span into the process buffer; returns its
    span id. The buffer is drained into the JSONL stream by the
    telemetry recorder (locked snapshot-and-clear)."""
    global _spans_dropped
    ev = make_span(name, t_start, t_end, trace_id=trace_id,
                   span_id=span_id, parent_id=parent_id, attrs=attrs)
    with _spans_lock:
        if len(_spans) < _SPANS_CAP:
            _spans.append(ev)
        else:
            _spans_dropped += 1
    return ev["span_id"]


class _SpanHandle:
    """What :func:`span` yields: the ids children parent to, plus a
    mutable ``attrs`` dict stamped onto the span when it closes."""

    __slots__ = ("trace_id", "span_id", "parent_id", "attrs")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: Optional[str],
                 attrs: Optional[Dict[str, Any]]):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.attrs = dict(attrs) if attrs else {}


@contextmanager
def span(name: str, *, trace_id: Optional[str] = None,
         parent_id: Optional[str] = None,
         attrs: Optional[Dict[str, Any]] = None
         ) -> Iterator[_SpanHandle]:
    """Record the enclosed section as a span. Without an explicit
    ``trace_id`` the process-current context supplies trace and
    parent; with neither, the span roots a fresh trace."""
    if trace_id is None:
        ctx = current_context()
        if ctx is not None:
            trace_id = ctx["trace_id"]
            if parent_id is None:
                parent_id = ctx["span_id"]
    handle = _SpanHandle(trace_id or new_trace_id(), new_span_id(),
                         parent_id, attrs)
    t0 = time.perf_counter()
    try:
        yield handle
    finally:
        record_span(name, t0, trace_id=handle.trace_id,
                    span_id=handle.span_id,
                    parent_id=handle.parent_id, attrs=handle.attrs)


def drain_span_events() -> List[Dict[str, Any]]:
    """Locked snapshot-and-clear of the span buffer (the same drain
    contract as ``resilience.faults.drain_events``)."""
    global _spans, _spans_dropped
    with _spans_lock:
        if not _spans:
            return []
        out, _spans = _spans, []
        _spans_dropped = 0
    return out


def span_events_snapshot() -> List[Dict[str, Any]]:
    """Copy of the pending (undrained) spans, for tests/inspection."""
    with _spans_lock:
        return list(_spans)


def record_iteration_spans(event: Dict[str, Any], t_start: float,
                           t_end: float) -> None:
    """Derive the per-iteration spans from one telemetry iteration
    event (obs/recorder.py): a ``train/iteration`` parent covering
    [t_start, t_end] plus one ``phase/<label>`` child per Timer phase
    delta, laid out sequentially (phase clocks are per-label
    accumulators, not timestamps — relative placement inside the
    iteration is synthetic, the durations are real).

    An event with a ``scan`` record (the JAX package's fused scan) also
    gets ``host_gap_s`` = iteration wall minus the blocking phase.

    Costs one clock pair + a handful of locked appends per
    ITERATION."""
    ctx = current_context()
    if ctx is None:
        # a bare train() run still groups its iterations in one trace
        set_current_trace(new_trace_id())
        ctx = current_context()
    attrs: Dict[str, Any] = {"iteration": event.get("iteration")}
    scan = event.get("scan")
    phases = event.get("phases") or {}

    def _total(v: Dict[str, Any]) -> float:
        # single-process deltas carry total; SPMD-aggregated carry
        # mean (per-process) + min/max
        return float(v.get("total", v.get("mean", 0.0)))

    if scan:
        blocking = sum(_total(phases[lb]) for lb in BLOCKING_PHASES
                       if lb in phases)
        attrs["scan"] = scan
        attrs["host_gap_s"] = round(
            max((t_end - t_start) - blocking, 0.0), 6)
    parent = record_span("train/iteration", t_start, t_end,
                         trace_id=ctx["trace_id"],
                         parent_id=ctx["span_id"], attrs=attrs)
    cursor = t_start
    for label in sorted(phases):
        dur = _total(phases[label])
        if dur <= 0.0:
            continue
        record_span(f"phase/{label}", cursor, cursor + dur,
                    trace_id=ctx["trace_id"], parent_id=parent,
                    attrs={"count": int(phases[label]
                                        .get("count", 0))})
        cursor += dur


# ---------------------------------------------------------------------
# the `python -m lightgbm_tpu_torch trace <dir>` CLI: merge per-process
# streams, correct clock skew, reconstruct critical paths, export
# Chrome trace-event JSON (Perfetto-loadable)
# ---------------------------------------------------------------------

#: the stream names (x.jsonl, x.jsonl.rankN, x.jsonl.fleet) — the
#: same as obs/recorder._STREAM_NAME_RE, so `trace` and `stats` walk
#: the same files
_STREAM_NAME_RE = re.compile(r"\.jsonl(\.rank\d+|\.fleet)?$")


def load_spans(directory: str) -> List[Dict[str, Any]]:
    """Every ``{"event": "span"}`` line under ``directory``
    (recursive), each stamped with its stream's relative path under
    ``"_stream"``. A truncated FINAL line per stream is tolerated (a
    SIGKILLed replica lands mid-write); garbage before the last line
    raises — that is corruption, not a crash artifact."""
    from .recorder import _stream_lines

    spans: List[Dict[str, Any]] = []
    for root, _dirs, names in sorted(os.walk(directory)):
        for name in sorted(names):
            if not _STREAM_NAME_RE.search(name):
                continue
            path = os.path.join(root, name)
            rel = os.path.relpath(path, directory)

            def _parse(line: str, is_last: bool) -> Optional[dict]:
                try:
                    ev = json.loads(line)
                except ValueError:
                    if is_last:
                        return None        # mid-write crash artifact
                    raise ValueError(
                        f"{path}: malformed telemetry line "
                        f"{line[:80]!r}")
                return ev if isinstance(ev, dict) else None

            for ev in _stream_lines(path, _parse):
                if ev.get("event") != "span":
                    continue
                ev["_stream"] = rel
                spans.append(ev)
    return spans


def _proc_key(s: Dict[str, Any]) -> Tuple[str, str]:
    # (stream, proc): pids recycle across elastic restarts and hosts,
    # the stream they wrote into disambiguates the clock domain
    return (str(s.get("_stream", "")), str(s.get("proc", "?")))


def correct_clock_skew(spans: List[Dict[str, Any]]
                       ) -> Dict[Tuple[str, str], float]:
    """Place every span on one corrected timeline: per process, the
    offset between its monotonic clock and the shared wall clock is
    the median of ``wall - mono`` over its spans (the median rejects
    the occasional NTP step mid-run), and each span gains absolute
    ``t0``/``t1`` seconds = ``mono + offset``. Returns the per-process
    offsets (for the CLI's provenance print)."""
    groups: Dict[Tuple[str, str], List[Dict[str, Any]]] = \
        defaultdict(list)
    for s in spans:
        groups[_proc_key(s)].append(s)
    offsets: Dict[Tuple[str, str], float] = {}
    for key, group in groups.items():
        offsets[key] = statistics.median(
            float(s["wall"]) - float(s["mono"]) for s in group)
    for s in spans:
        t0 = float(s["mono"]) + offsets[_proc_key(s)]
        s["t0"] = t0
        s["t1"] = t0 + float(s.get("dur", 0.0))
    return offsets


def chrome_trace(spans: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Chrome trace-event JSON (the ``traceEvents`` array of complete
    ``ph: "X"`` events in microseconds, plus ``process_name``
    metadata) over skew-corrected spans — loadable in Perfetto /
    chrome://tracing. Timestamps are relative to the earliest span so
    the viewer opens at t=0."""
    if not spans:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    procs = sorted({_proc_key(s) for s in spans})
    pid_of = {key: i + 1 for i, key in enumerate(procs)}
    base = min(float(s["t0"]) for s in spans)
    events: List[Dict[str, Any]] = []
    for (stream, proc), pid in sorted(pid_of.items(),
                                      key=lambda kv: kv[1]):
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0,
                       "args": {"name": f"{proc} ({stream})"}})
    for s in spans:
        args = {"trace_id": s.get("trace_id"),
                "span_id": s.get("span_id"),
                "parent_id": s.get("parent_id"),
                **(s.get("attrs") or {})}
        events.append({
            "name": str(s.get("name", "?")),
            "ph": "X",
            "ts": round((float(s["t0"]) - base) * 1e6, 3),
            "dur": round(float(s.get("dur", 0.0)) * 1e6, 3),
            "pid": pid_of[_proc_key(s)],
            "tid": 0,
            "cat": str(s.get("name", "?")).split("/", 1)[0],
            "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


#: watcher swap phases in causal order (the JAX serve daemon's)
_SWAP_STEPS = ("swap/validate", "swap/load", "swap/stage",
               "swap/apply")


def critical_paths(spans: List[Dict[str, Any]]
                   ) -> List[Dict[str, Any]]:
    """Reconstruct the named lifecycle critical paths from
    skew-corrected spans (the JAX package's pipeline writes the publish,
    swap and request spans): for each trace that published a model,

        last train/iteration -> publish/model -> swap/validate ->
        load -> stage -> apply -> first serve/request answered by
        the swapped model

    The final hop joins ACROSS traces: request spans ride the
    client's trace, so the first request served by the new model is
    found by model id + corrected time (earliest ``serve/request``
    whose ``attrs.model`` matches the applied forest and whose start
    is at/after the swap's end)."""
    by_trace: Dict[str, List[Dict[str, Any]]] = defaultdict(list)
    requests: List[Dict[str, Any]] = []
    for s in spans:
        by_trace[str(s.get("trace_id"))].append(s)
        if s.get("name") == "serve/request":
            requests.append(s)
    requests.sort(key=lambda s: s["t0"])
    paths: List[Dict[str, Any]] = []
    for tid, group in by_trace.items():
        pubs = [s for s in group if s.get("name") == "publish/model"]
        if not pubs:
            continue
        pub = max(pubs, key=lambda s: s["t1"])
        steps: List[Dict[str, Any]] = []

        def _push(s: Dict[str, Any], label: Optional[str] = None
                  ) -> None:
            if steps and s["t0"] > steps[-1]["t1"]:
                steps.append({"name": "(wait)",
                              "t0": steps[-1]["t1"], "t1": s["t0"],
                              "dur_s": s["t0"] - steps[-1]["t1"],
                              "gap": True})
            steps.append({"name": label or str(s["name"]),
                          "t0": s["t0"], "t1": s["t1"],
                          "dur_s": float(s.get("dur", 0.0)),
                          "gap": False})

        iters = [s for s in group
                 if s.get("name") == "train/iteration"]
        if iters:
            last = max(iters, key=lambda s: (
                (s.get("attrs") or {}).get("iteration") or 0,
                s["t1"]))
            it_no = (last.get("attrs") or {}).get("iteration")
            _push(last, f"train/iteration #{it_no}")
        _push(pub)
        model = None
        swap_end = None
        # several replicas may swap; follow the EARLIEST completed
        # apply (the first replica able to answer from the new model)
        applies = sorted(
            (s for s in group if s.get("name") == "swap/apply"),
            key=lambda s: s["t1"])
        if applies:
            apply_proc = _proc_key(applies[0])
            for name in _SWAP_STEPS:
                cands = [s for s in group if s.get("name") == name
                         and _proc_key(s) == apply_proc]
                if cands:
                    _push(min(cands, key=lambda s: s["t0"]))
            model = (applies[0].get("attrs") or {}).get("model")
            swap_end = applies[0]["t1"]
        served = None
        if model is not None and swap_end is not None:
            for req in requests:
                if (req.get("attrs") or {}).get("model") == model \
                        and req["t0"] >= swap_end:
                    served = req
                    break
            if served is not None:
                _push(served, f"serve/request (model {model})")
        paths.append({
            "trace_id": tid,
            "generation": (pub.get("attrs") or {}).get("generation"),
            "model": model,
            "complete": bool(iters and applies and served),
            "steps": steps,
            "total_s": (steps[-1]["t1"] - steps[0]["t0"])
            if steps else 0.0,
        })
    paths.sort(key=lambda p: (p["generation"] is None,
                              p["generation"], p["trace_id"]))
    return paths


def render_critical_paths(paths: List[Dict[str, Any]]) -> str:
    lines: List[str] = []
    for p in paths:
        gen = p["generation"]
        head = f"critical path · generation " \
               f"{'?' if gen is None else gen} · trace " \
               f"{p['trace_id']}" \
               f"{'' if p['complete'] else ' · INCOMPLETE'}"
        lines.append(head)
        t_base = p["steps"][0]["t0"] if p["steps"] else 0.0
        for st in p["steps"]:
            at = st["t0"] - t_base
            lines.append(f"  {st['name']:44s} +{at:9.3f}s  "
                         f"{st['dur_s'] * 1e3:10.2f} ms")
        lines.append(f"  {'TOTAL iteration -> first-served':44s} "
                     f"{'':10s} {p['total_s'] * 1e3:10.2f} ms")
        lines.append("")
    return "\n".join(lines).rstrip()


_TRACE_HELP = """\
usage: python -m lightgbm_tpu_torch trace <telemetry-dir> [--out FILE]

Merge every telemetry stream under the directory (x.jsonl plus the
fleet's .rankN / .fleet suffixes, recursively), collect the
{"event": "span"} lines, correct cross-process clock skew from each
span's paired wall/monotonic timestamps, and:

- write Chrome trace-event JSON (default <dir>/trace.json) — open it
  at https://ui.perfetto.dev or chrome://tracing,
- print the reconstructed lifecycle critical paths: last trained
  iteration -> publish -> manifest-validated swap -> first request
  served by the new model, with clock-corrected latencies.

The span schema is obs/schemas.py EVENTS["span"].

exit codes:
  0  spans merged and exported (even if no complete critical path)
  1  no span events found, unreadable directory, or corrupt stream
"""


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in ("-h", "--help"):
        print(_TRACE_HELP)
        return 0
    out_path = None
    if "--out" in argv:
        i = argv.index("--out")
        if i + 1 >= len(argv):
            print("trace: --out needs a file argument",
                  file=sys.stderr)
            return 1
        out_path = argv[i + 1]
        del argv[i:i + 2]
    if len(argv) != 1:
        print("usage: python -m lightgbm_tpu_torch trace <telemetry-dir> "
              "[--out FILE]", file=sys.stderr)
        return 1
    directory = argv[0]
    if not os.path.isdir(directory):
        print(f"[LightGBM-TPU] [Fatal] not a directory: {directory}",
              file=sys.stderr)
        return 1
    try:
        spans = load_spans(directory)
    except OSError as e:
        print(f"[LightGBM-TPU] [Fatal] cannot read {directory}: {e}",
              file=sys.stderr)
        return 1
    except ValueError as e:
        print(f"[LightGBM-TPU] [Fatal] corrupt telemetry: {e}",
              file=sys.stderr)
        return 1
    if not spans:
        print(f"no span events in any *.jsonl under {directory}",
              file=sys.stderr)
        return 1
    offsets = correct_clock_skew(spans)
    doc = chrome_trace(spans)
    out_path = out_path or os.path.join(directory, "trace.json")
    try:
        with open(out_path, "w", encoding="utf-8") as fh:
            json.dump(doc, fh)
    except OSError as e:
        print(f"[LightGBM-TPU] [Fatal] cannot write {out_path}: {e}",
              file=sys.stderr)
        return 1
    print(f"{len(spans)} span(s) from {len(offsets)} process(es) -> "
          f"{out_path} (Perfetto/chrome://tracing)")
    if len(offsets) > 1:
        monos = sorted(offsets.values())
        print(f"clock-skew correction: per-process mono->wall "
              f"offsets spread over {monos[-1] - monos[0]:.3f} s")
    paths = critical_paths(spans)
    if paths:
        print()
        print(render_critical_paths(paths))
    else:
        print("no publish spans: critical paths need a traced "
              "publish -> swap -> serve lifecycle (run the pipeline "
              "with tracing on)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
