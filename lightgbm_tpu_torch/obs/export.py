"""OpenMetrics export of the MetricsRegistry: a copy of
``lightgbm_tpu/obs/export.py``.

- :func:`render_openmetrics` — the pure render (registry snapshot ->
  OpenMetrics / Prometheus text, the JAX package's family names under
  the same ``lightgbm_tpu_`` prefix);
- :class:`MetricsHTTPServer` / :func:`ensure_metrics_server` — a
  stdlib ``http.server`` ``/metrics`` endpoint (``metrics_port`` or
  ``LIGHTGBM_TPU_METRICS_PORT``, port + rank per process);
- :func:`parse_openmetrics` — the strict line-grammar reader.

The render always runs on ``registry.snapshot()`` — a copy taken under
the registry's lock — never on live instruments, so a slow scraper can
never stall a training iteration's counter bump.
"""

from __future__ import annotations

import re
import threading
from typing import Callable, Dict, List, Optional, Tuple

from ..log import log_info, log_warning
from .registry import MetricsRegistry
from .registry import registry as _global_registry

__all__ = ["render_openmetrics", "parse_openmetrics",
           "MetricsHTTPServer", "ensure_metrics_server",
           "counter_family", "gauge_family",
           "CONTENT_TYPE", "METRIC_PREFIX"]

#: every exported family is namespaced under this prefix
METRIC_PREFIX = "lightgbm_tpu_"

#: the OpenMetrics text content type (Prometheus accepts it and falls
#: back to the 0.0.4 text parse if it must)
CONTENT_TYPE = "application/openmetrics-text; version=1.0.0; " \
               "charset=utf-8"

_NAME_OK = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*$")
_NAME_FIX = re.compile(r"[^a-zA-Z0-9_]")


def _metric_name(raw: str) -> str:
    """A legal OpenMetrics metric/label name from a registry name
    (phase labels carry '/', '-', etc.)."""
    name = _NAME_FIX.sub("_", str(raw))
    if not name or not _NAME_OK.match(name):
        name = "_" + name
    return name


def _escape_label_value(value: str) -> str:
    return (str(value).replace("\\", "\\\\").replace("\"", "\\\"")
            .replace("\n", "\\n"))


def _labels_text(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{_metric_name(k)}="{_escape_label_value(v)}"'
        for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _num(value) -> str:
    """OpenMetrics sample value: integers render bare, floats via
    repr (full precision round-trips through the parser)."""
    f = float(value)
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def render_openmetrics(snapshot: Dict[str, Dict[str, object]],
                       extra: Optional[Dict[str, Dict[str,
                                                      object]]] = None,
                       prefix: str = METRIC_PREFIX) -> str:
    """Render a ``MetricsRegistry.snapshot()`` dict as OpenMetrics
    text (terminated by ``# EOF``).

    ``extra`` merges additional families of the same snapshot shape
    (``{name: {"kind": ..., "series": [{"labels": ..., ...}]}}``), for
    numbers that are computed per scrape and never stored in the
    registry.

    Pure function over copies: callers hand in snapshots, so no lock
    is ever held here.
    """
    families = dict(snapshot)
    if extra:
        families.update(extra)
    lines: List[str] = []
    for raw_name in sorted(families):
        fam = families[raw_name]
        kind = str(fam.get("kind", "gauge"))
        series = fam.get("series") or []
        base = prefix + _metric_name(raw_name)
        if kind == "counter":
            # registry counters named *_total (publish_total, ...)
            # already carry the OpenMetrics suffix; the family name
            # drops it so samples never read *_total_total
            if base.endswith("_total"):
                base = base[:-len("_total")]
            lines.append(f"# TYPE {base} counter")
            for row in series:
                labels = _labels_text(row.get("labels") or {})
                value = row.get("value")
                if value is None:
                    continue
                lines.append(f"{base}_total{labels} {_num(value)}")
        elif kind == "gauge":
            rows = [row for row in series
                    if row.get("value") is not None]
            if rows:
                lines.append(f"# TYPE {base} gauge")
                for row in rows:
                    labels = _labels_text(row.get("labels") or {})
                    lines.append(f"{base}{labels} "
                                 f"{_num(row['value'])}")
            max_rows = [row for row in series
                        if row.get("max") is not None]
            if max_rows:
                lines.append(f"# TYPE {base}_max gauge")
                for row in max_rows:
                    labels = _labels_text(row.get("labels") or {})
                    lines.append(f"{base}_max{labels} "
                                 f"{_num(row['max'])}")
        elif kind == "histogram":
            # the registry keeps streaming moments, not buckets: the
            # faithful OpenMetrics mapping is a summary (count + sum)
            # plus min/max gauges
            lines.append(f"# TYPE {base} summary")
            for row in series:
                labels = _labels_text(row.get("labels") or {})
                lines.append(f"{base}_count{labels} "
                             f"{_num(row.get('count', 0))}")
                lines.append(f"{base}_sum{labels} "
                             f"{_num(row.get('total', 0.0))}")
            for bound in ("min", "max"):
                rows = [row for row in series
                        if row.get(bound) is not None]
                if rows:
                    lines.append(f"# TYPE {base}_{bound} gauge")
                    for row in rows:
                        labels = _labels_text(row.get("labels") or {})
                        lines.append(f"{base}_{bound}{labels} "
                                     f"{_num(row[bound])}")
        else:  # unknown kind: degrade to untyped gauges, never drop
            lines.append(f"# TYPE {base} gauge")
            for row in series:
                labels = _labels_text(row.get("labels") or {})
                value = row.get("value")
                if value is not None:
                    lines.append(f"{base}{labels} {_num(value)}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def counter_family(value, **labels) -> Dict[str, object]:
    """One-sample counter in the snapshot-family shape ``extra``
    providers hand :func:`render_openmetrics`."""
    return {"kind": "counter",
            "series": [{"labels": labels, "value": value}]}


def gauge_family(value, **labels) -> Dict[str, object]:
    """One-sample gauge in the snapshot-family shape (None values are
    skipped by the render, so callers never need to branch)."""
    return {"kind": "gauge",
            "series": [{"labels": labels, "value": value}]}


# ---------------------------------------------------------------------
# strict line-grammar parser (the scraper + golden-parse side)
# ---------------------------------------------------------------------

_TYPE_RE = re.compile(
    r"^# TYPE ([a-zA-Z_][a-zA-Z0-9_]*) "
    r"(counter|gauge|summary|histogram|untyped)$")
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_][a-zA-Z0-9_]*)"
    r"(\{[^{}]*\})? "
    r"(NaN|[+-]Inf|-?[0-9]+(?:\.[0-9]+)?(?:[eE][+-]?[0-9]+)?)$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape_label_value(value: str) -> str:
    # one left-to-right scan, NOT chained str.replace: sequential
    # replaces decode the escaped form of a literal backslash
    # followed by 'n' ('\\\\n') into backslash+newline
    out = []
    i = 0
    while i < len(value):
        ch = value[i]
        if ch == "\\" and i + 1 < len(value):
            nxt = value[i + 1]
            if nxt == "n":
                out.append("\n")
                i += 2
                continue
            if nxt in ("\\", '"'):
                out.append(nxt)
                i += 2
                continue
        out.append(ch)
        i += 1
    return "".join(out)


def _parse_value(text: str) -> float:
    if text == "NaN":
        return float("nan")
    if text == "+Inf":
        return float("inf")
    if text == "-Inf":
        return float("-inf")
    return float(text)


def parse_openmetrics(text: str) \
        -> Dict[str, Dict[Tuple[Tuple[str, str], ...], float]]:
    """Parse OpenMetrics text with a strict line grammar (no client
    library): every line must be a ``# TYPE`` declaration, a sample,
    or the final ``# EOF`` — anything else raises ``ValueError``.

    Returns ``{sample_name: {sorted_label_items: value}}`` (sample
    names keep their ``_total``/``_count``/... suffixes, so the
    round-trip against :func:`render_openmetrics` is exact).
    """
    out: Dict[str, Dict[Tuple[Tuple[str, str], ...], float]] = {}
    saw_eof = False
    for lineno, raw in enumerate(text.splitlines(), start=1):
        line = raw.rstrip("\r")
        if not line:
            continue
        if saw_eof:
            raise ValueError(f"line {lineno}: content after # EOF")
        if line == "# EOF":
            saw_eof = True
            continue
        if line.startswith("#"):
            if _TYPE_RE.match(line):
                continue
            raise ValueError(
                f"line {lineno}: not a # TYPE declaration: {line!r}")
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: not a sample: {line!r}")
        name, labels_blob, value = m.group(1), m.group(2), m.group(3)
        labels: List[Tuple[str, str]] = []
        if labels_blob:
            inner = labels_blob[1:-1]
            matched = _LABEL_RE.findall(inner)
            rebuilt = ",".join(f'{k}="{v}"' for k, v in matched)
            if rebuilt != inner:
                raise ValueError(
                    f"line {lineno}: malformed label set: "
                    f"{labels_blob!r}")
            labels = [(k, _unescape_label_value(v))
                      for k, v in matched]
        out.setdefault(name, {})[tuple(sorted(labels))] = \
            _parse_value(value)
    if not saw_eof:
        raise ValueError("missing # EOF terminator")
    return out


# ---------------------------------------------------------------------
# the /metrics endpoint
# ---------------------------------------------------------------------

# per-endpoint scrape bookkeeping, keyed by bound port: written by the
# server's request-handler threads (every GET is one scrape), read by
# scrape_count() callers on the main path and exported as
# lightgbm_tpu_metrics_scrapes_total; every touch goes through
# _scrape_lock.
_scrape_lock = threading.Lock()
_scrape_counts: Dict[int, int] = {}


class MetricsHTTPServer:
    """Stdlib ``/metrics`` endpoint over one registry.

    A daemon thread runs a ``ThreadingHTTPServer``, which handles
    every GET on its own request thread: the handler bumps the scrape
    counter under ``_scrape_lock``, takes a registry snapshot (the
    only other locked step, inside the registry), and renders outside
    any lock. ``extra_families`` is an optional zero-arg callable
    returning additional snapshot-shaped families; it runs on the
    scrape thread and must be cheap and lock-disciplined itself.
    """

    def __init__(self, port: int,
                 registry: Optional[MetricsRegistry] = None,
                 extra_families: Optional[Callable[[], Dict]] = None,
                 host: str = "127.0.0.1"):
        import http.server

        self.registry = registry if registry is not None \
            else _global_registry
        self.extra_families = extra_families

        exporter = self

        class _Handler(http.server.BaseHTTPRequestHandler):
            # one request per connection is fine at scrape cadence
            protocol_version = "HTTP/1.0"

            def do_GET(self) -> None:  # noqa: N802 (stdlib API name)
                if self.path.split("?", 1)[0] not in ("/metrics", "/"):
                    self.send_error(404)
                    return
                with _scrape_lock:
                    count = _scrape_counts.get(exporter.port, 0) + 1
                    _scrape_counts[exporter.port] = count
                try:                     # render OUTSIDE the lock
                    body = exporter.render(scrapes=count) \
                        .encode("utf-8")
                except Exception as e:   # never kill the scrape thread
                    self.send_error(500, str(e)[:200])
                    return
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args) -> None:
                pass                     # scrapes must not spam stderr

        self._server = http.server.ThreadingHTTPServer(
            (host, int(port)), _Handler)
        self._server.daemon_threads = True
        self.host = host
        self.port = int(self._server.server_address[1])
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            kwargs={"poll_interval": 0.5}, daemon=True,
            name="lightgbm-tpu-metrics")
        self._thread.start()
        log_info(f"metrics: /metrics endpoint on "
                 f"http://{host}:{self.port}/metrics")

    def render(self, scrapes: Optional[int] = None) -> str:
        """One scrape: snapshot (locked, inside the registry), render
        (no lock). The endpoint's own scrape count rides along as
        ``lightgbm_tpu_metrics_scrapes_total``."""
        if scrapes is None:
            scrapes = self.scrape_count()
        snapshot = self.registry.snapshot()
        extra = {"metrics_scrapes": {
            "kind": "counter",
            "series": [{"labels": {}, "value": scrapes}]}}
        if self.extra_families is not None:
            try:
                extra.update(self.extra_families() or {})
            except Exception as e:
                log_warning(f"metrics: extra families provider failed "
                            f"({e}); exporting registry only")
        return render_openmetrics(snapshot, extra=extra)

    def scrape_count(self) -> int:
        with _scrape_lock:
            return _scrape_counts.get(self.port, 0)

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()


# one endpoint per process: repeated train() calls (cv folds) must
# reuse the first server, not fight over the port. Guarded by
# _server_lock.
_server_lock = threading.Lock()
_server: Optional[MetricsHTTPServer] = None


def ensure_metrics_server(port: int,
                          registry: Optional[MetricsRegistry] = None,
                          extra_families: Optional[
                              Callable[[], Dict]] = None) \
        -> Optional[MetricsHTTPServer]:
    """Start the process-wide ``/metrics`` endpoint once; subsequent
    calls return the existing server (whatever port it bound). A bind
    failure warns and returns None — metrics must degrade, never take
    down training or serving."""
    global _server
    with _server_lock:
        if _server is not None:
            return _server
        try:
            _server = MetricsHTTPServer(
                port, registry=registry, extra_families=extra_families)
        except OSError as e:
            log_warning(f"metrics: cannot bind /metrics endpoint on "
                        f"port {port} ({e}); export disabled for this "
                        "process")
            return None
        return _server
