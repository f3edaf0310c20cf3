"""User-defined application metrics: Counter, Gauge, Histogram (a copy of
ray_tpu/util/metrics.py over the port's process tiers).

Each process keeps a local registry.  The process that calls ``init()``
(the driver) reads its own directly; a task worker's snapshots travel
back with each task's result (``take_dirty_snapshots``, merged by
``merge_remote``); an actor pushes its snapshots into the session's
``_control`` store after each call and every 2 s from a background
flusher, as the JAX package's workers push theirs to the driver.
``prometheus_text()`` renders the merged view in the Prometheus
exposition format, and ``start_metrics_server(port)`` serves it over HTTP
on localhost for scraping.
"""

from __future__ import annotations

import pickle
import re
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")

DEFAULT_HISTOGRAM_BOUNDARIES = [
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 50.0, 100.0]

_registry_lock = threading.Lock()
_registry: Dict[str, "Metric"] = {}
_flusher_started = False
# Bumped by _reset_for_tests so an already-running flusher thread exits
# at its next wakeup instead of surviving the reset.
_flusher_gen = 0
# Set by every record, cleared by flush: lets the per-task flush hook
# skip the push entirely when nothing changed since the last one.
_dirty = False
#: source -> the latest snapshots of a process of the session (task
#: workers' arrive with their tasks' results; actors' are read from the
#: session's store at scrape time).
_remote: Dict[str, List[Dict[str, Any]]] = {}
_remote_lock = threading.Lock()
#: The session store's key prefix of actors' pushed snapshots.
_KV_PREFIX = "metrics/"


def _tags_key(tags: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted(tags.items()))


class Metric:
    """Base class; subclasses define how observations fold into state."""

    metric_type = "untyped"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Optional[Sequence[str]] = None):
        if not _NAME_RE.match(name or ""):
            raise ValueError(f"invalid Prometheus metric name {name!r}")
        self._name = name
        self._description = description
        self._tag_keys = tuple(tag_keys or ())
        self._default_tags: Dict[str, str] = {}
        self._lock = threading.Lock()
        # tags-key -> state (scalar for counter/gauge, bucket list for histo)
        self._values: Dict[Tuple[Tuple[str, str], ...], Any] = {}
        with _registry_lock:
            existing = _registry.get(name)
            if existing is not None:
                if existing.metric_type != self.metric_type:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.metric_type}")
                self._check_alias_compatible(existing)
                # Same-name metrics aggregate (Ray semantics): share the
                # canonical instance's state so no recorded value is lost.
                self._values = existing._values
                self._lock = existing._lock
            else:
                _registry[name] = self
        _ensure_flusher()

    @property
    def info(self) -> Dict[str, Any]:
        return {"name": self._name, "description": self._description,
                "tag_keys": self._tag_keys,
                "default_tags": dict(self._default_tags)}

    def set_default_tags(self, tags: Dict[str, str]) -> "Metric":
        self._default_tags = dict(tags)
        return self

    def _merge_tags(self, tags: Optional[Dict[str, str]]) -> Dict[str, str]:
        merged = dict(self._default_tags)
        if tags:
            unknown = set(tags) - set(self._tag_keys)
            if unknown:
                raise ValueError(
                    f"unknown tag keys {sorted(unknown)} for metric "
                    f"{self._name!r} (declared: {list(self._tag_keys)})")
            merged.update(tags)
        return merged

    def _check_alias_compatible(self, existing: "Metric") -> None:
        """Subclass hook: validate shape-compatibility with the canonical
        same-name instance whose state this one is about to share."""

    def _samples(self) -> List[Tuple[str, Dict[str, str], float]]:
        raise NotImplementedError

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "name": self._name, "type": self.metric_type,
                "description": self._description,
                "samples": [(n, dict(t), v) for n, t, v in self._samples()],
            }


class Counter(Metric):
    metric_type = "counter"

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None) -> None:
        global _dirty
        if value <= 0:
            raise ValueError("Counter.inc() value must be positive")
        key = _tags_key(self._merge_tags(tags))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value
        _dirty = True

    def _samples(self):
        return [(self._name, dict(k), v) for k, v in self._values.items()]


class Gauge(Metric):
    metric_type = "gauge"

    def set(self, value: float, tags: Optional[Dict[str, str]] = None) -> None:
        global _dirty
        key = _tags_key(self._merge_tags(tags))
        with self._lock:
            self._values[key] = float(value)
        _dirty = True

    def _samples(self):
        return [(self._name, dict(k), v) for k, v in self._values.items()]


class Histogram(Metric):
    metric_type = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Optional[Sequence[float]] = None,
                 tag_keys: Optional[Sequence[str]] = None):
        self._boundaries = sorted(boundaries or DEFAULT_HISTOGRAM_BOUNDARIES)
        super().__init__(name, description, tag_keys)

    def _check_alias_compatible(self, existing: "Metric") -> None:
        # Shared bucket lists are sized by the canonical boundaries;
        # mismatched boundaries would mis-index or IndexError on observe().
        if tuple(self._boundaries) != tuple(existing._boundaries):
            raise ValueError(
                f"histogram {self._name!r} already registered with "
                f"boundaries {existing._boundaries}; got "
                f"{self._boundaries}")

    def observe_many(self, values: Sequence[float],
                     tags: Optional[Dict[str, str]] = None) -> None:
        """Record a batch of observations under ONE tag-key resolution
        and lock acquisition — for amortized publishers (e.g. the task
        event ring folding a thousand stage waits at once) where a
        per-value observe() would put lock traffic on a hot path."""
        if not values:
            return
        key = _tags_key(self._merge_tags(tags))
        with self._lock:
            state = self._values.get(key)
            if state is None:
                state = {"buckets": [0] * (len(self._boundaries) + 1),
                         "sum": 0.0, "count": 0}
                self._values[key] = state
            buckets = state["buckets"]
            last = len(self._boundaries)
            for value in values:
                idx = last
                for i, b in enumerate(self._boundaries):
                    if value <= b:
                        idx = i
                        break
                buckets[idx] += 1
                state["sum"] += value
            state["count"] += len(values)
        global _dirty
        _dirty = True

    def observe(self, value: float,
                tags: Optional[Dict[str, str]] = None) -> None:
        self.observe_many((value,), tags=tags)

    def _samples(self):
        out = []
        for k, state in self._values.items():
            tags = dict(k)
            cum = 0
            for i, b in enumerate(self._boundaries):
                cum += state["buckets"][i]
                out.append((f"{self._name}_bucket",
                            {**tags, "le": repr(float(b))}, float(cum)))
            cum += state["buckets"][-1]
            out.append((f"{self._name}_bucket", {**tags, "le": "+Inf"},
                        float(cum)))
            out.append((f"{self._name}_sum", tags, state["sum"]))
            out.append((f"{self._name}_count", tags, float(state["count"])))
        return out


# --------------------------------------------------------------------------
# export: worker -> driver, Prometheus text rendering, scrape server
# --------------------------------------------------------------------------

def local_snapshots() -> List[Dict[str, Any]]:
    with _registry_lock:
        metrics = list(_registry.values())
    return [m.snapshot() for m in metrics]


def _process_role() -> str:
    """"actor", "task" (a task worker) or "driver"."""
    from .. import _actor, _tasks
    if _actor._in_actor is not None:
        return "actor"
    if _tasks._in_worker is not None:
        return "task"
    return "driver"


def _source_id() -> str:
    """``actor-<actor id>`` in an actor (the key its pushes go under),
    else the role and the pid."""
    from .. import _actor
    if _actor._in_actor is not None:
        return f"actor-{_actor._in_actor['actor_id']}"
    import os
    return f"{_process_role()}-{os.getpid()}"


def take_dirty_snapshots() -> Optional[List[Dict[str, Any]]]:
    """This process's snapshots when something was recorded since the
    last take, else None (a task worker, at each task's end)."""
    global _dirty
    if not _dirty:
        return None
    _dirty = False
    return local_snapshots()


def merge_remote(source: str, snaps: List[Dict[str, Any]]) -> None:
    """Keep another process's latest snapshots under ``source``."""
    with _remote_lock:
        _remote[source] = snaps


def retire_source(source: str) -> None:
    """An actor ended: keep its last pushed snapshots in this process's
    view (its counters do not go back) and drop its key from the store."""
    from .. import _control
    plane = _control._current
    if plane is None:
        return
    raw = plane.kv_get(_KV_PREFIX + source)
    if raw is not None:
        merge_remote(source, pickle.loads(raw))
    plane.kv_del(_KV_PREFIX + source)


def flush() -> None:
    """Push this actor's metrics into the session's store (no-op in the
    driver, whose registry is read directly, and in a task worker, whose
    snapshots go back with its tasks)."""
    global _dirty
    if _process_role() != "actor":
        return
    from .._control import current
    _dirty = False
    try:
        current().kv_put(_KV_PREFIX + _source_id(),
                         pickle.dumps(local_snapshots()))
    except Exception:  # noqa: BLE001 - the session is ending
        _dirty = True


def flush_on_task_done() -> None:
    """Deterministic flush at the end of an actor call, before its reply
    is sent: by the time the caller sees the call finished, its metrics
    are in the store.  Skips the push when nothing was recorded since the
    last flush."""
    if _dirty:
        flush()


def _ensure_flusher() -> None:
    """Start the background flusher once, in actor processes only."""
    global _flusher_started
    if _flusher_started or _process_role() != "actor":
        return
    _flusher_started = True
    gen = _flusher_gen

    def loop():
        while gen == _flusher_gen:
            time.sleep(2.0)
            if _dirty:
                flush()

    from .. import _sanitizer
    _sanitizer.spawn(loop, name="ray_tpu-metrics-flush")


def _merged_snapshots() -> List[Dict[str, Any]]:
    """This process's metrics + the latest snapshots of every task
    worker and actor of the session."""
    snaps = local_snapshots()
    with _remote_lock:
        for worker_snaps in _remote.values():
            snaps.extend(worker_snaps)
    from .. import _control
    plane = _control._current
    if plane is not None:
        for key in plane.kv_keys(_KV_PREFIX):
            raw = plane.kv_get(key)
            if raw is not None and key != _KV_PREFIX + _source_id():
                snaps.extend(pickle.loads(raw))
    return snaps


def _escape_tag_value(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _aggregate_snapshots():
    """Merge per-process snapshots per (sample name, tag set): counters
    and histogram buckets sum across processes, gauges take the latest
    writer.  The single merge rule both exporters share.  Returns
    (metric-name -> snapshot meta, sample-name -> {tags-key -> (tags,
    value)})."""
    by_name: Dict[str, Dict[str, Any]] = {}
    acc: Dict[str, Dict[Tuple, tuple]] = {}
    for snap in _merged_snapshots():
        by_name.setdefault(snap["name"], snap)
        summable = snap["type"] in ("counter", "histogram")
        for sample_name, tags, value in snap["samples"]:
            bucket = acc.setdefault(sample_name, {})
            key = _tags_key(tags)
            if summable:
                prev = bucket.get(key)
                bucket[key] = (tags, (prev[1] if prev else 0.0) + value)
            else:
                bucket[key] = (tags, value)
    return by_name, acc


def prometheus_text() -> str:
    """Render all known metrics in Prometheus exposition format."""
    by_name, acc = _aggregate_snapshots()
    lines: List[str] = []
    emitted_meta = set()
    for sample_name, bucket in acc.items():
        base = sample_name
        for suffix in ("_bucket", "_sum", "_count"):
            if base.endswith(suffix) and base[: -len(suffix)] in by_name:
                base = base[: -len(suffix)]
        meta = by_name.get(base)
        if meta and base not in emitted_meta:
            emitted_meta.add(base)
            if meta["description"]:
                lines.append(f"# HELP {base} {meta['description']}")
            lines.append(f"# TYPE {base} {meta['type']}")
        for key, (_tags, value) in sorted(bucket.items()):
            if key:
                tag_str = ",".join(
                    f'{k}="{_escape_tag_value(v)}"' for k, v in key)
                lines.append(f"{sample_name}{{{tag_str}}} {value}")
            else:
                lines.append(f"{sample_name} {value}")
    return "\n".join(lines) + ("\n" if lines else "")


_server = None


def start_metrics_server(port: int = 0):
    """Serve prometheus_text() on http://localhost:port/metrics; returns the
    bound port (reference: dashboard metrics exposition)."""
    global _server
    import http.server

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            # Serve at both / and /metrics (trailing slash tolerated).
            if self.path.rstrip("/") in ("", "/metrics"):
                body = prometheus_text().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self.send_response(404)
                self.end_headers()

        def log_message(self, *a):
            pass

    stop_metrics_server()  # a leftover server would serve the old registry
    _server = http.server.ThreadingHTTPServer(("127.0.0.1", port), Handler)
    from .. import _sanitizer
    _sanitizer.spawn(_server.serve_forever, name="ray_tpu-metrics-http")
    return _server.server_address[1]


def stop_metrics_server() -> None:
    """Shut down the scrape server started by start_metrics_server()
    (closes the listening socket and stops its thread)."""
    global _server
    srv, _server = _server, None
    if srv is not None:
        try:
            srv.shutdown()
            srv.server_close()
        except Exception:
            pass


def _reset_for_tests() -> None:
    global _flusher_started, _flusher_gen, _dirty
    stop_metrics_server()  # don't leak a ThreadingHTTPServer per test
    with _registry_lock:
        _registry.clear()
    with _remote_lock:
        _remote.clear()
    _flusher_started = False
    _flusher_gen += 1  # retire any live flusher thread at next wakeup
    _dirty = False
    from . import telemetry
    telemetry._reset_for_tests()


def export_otlp_json(path: str, window_s: Optional[float] = None) -> str:
    """Write the cluster-merged metrics in the OTLP/JSON resourceMetrics
    shape (reference: the OpenTelemetry metrics exporter behind
    open_telemetry_metric_recorder.h — here the file-based OTLP/JSON
    flavor, importable by any OTLP-compatible backend).  Counters land as
    monotonic sums, gauges as gauges, histograms as explicit-bucket
    histogram points.  Per-process snapshots are aggregated per
    (metric, tag-set) first — counters and histogram buckets sum,
    gauges take the latest writer — so one OTLP document never carries
    duplicate same-name points (mirrors prometheus_text).

    ``window_s`` (the head's time-series store) is refused until the
    cluster's operator surfaces are ported (ROADMAP Queue 1 item 14)."""
    import json

    now_ns = int(time.time() * 1e9)

    def attrs(tags: Dict[str, str]):
        return [{"key": k, "value": {"stringValue": str(v)}}
                for k, v in sorted(tags.items())]

    if window_s is not None:
        raise NotImplementedError(
            "export_otlp_json(window_s=...) reads the head's time-series "
            "store, which comes with the cluster's operator surfaces "
            "(ROADMAP Queue 1 item 14)")

    by_name, acc = _aggregate_snapshots()
    samples_by_metric: Dict[str, list] = {}
    for sample_name, bucket in acc.items():
        base = sample_name
        for suffix in ("_bucket", "_sum", "_count"):
            if sample_name.endswith(suffix) and \
                    sample_name[: -len(suffix)] in by_name:
                base = sample_name[: -len(suffix)]
                break
        # Insertion order, NOT sorted: histogram buckets must stay in the
        # ascending-le order their snapshots emit (the cumulative ->
        # per-bucket conversion below depends on it).
        samples_by_metric.setdefault(base, []).extend(
            (sample_name, tags, value)
            for _k, (tags, value) in bucket.items())

    otlp_metrics = []
    for name, meta in by_name.items():
        snap = {"name": name, "type": meta["type"],
                "description": meta.get("description", ""),
                "samples": samples_by_metric.get(name, [])}
        base = {"name": snap["name"],
                "description": snap.get("description", "")}
        mtype = snap["type"]
        if mtype == "histogram":
            # Samples carry per-bucket counts plus _sum/_count rows;
            # regroup them into histogram data points per tag set.
            by_tags: Dict[tuple, Dict[str, Any]] = {}
            for name, tags, value in snap["samples"]:
                le = tags.get("le")
                key = tuple(sorted((k, v) for k, v in tags.items()
                                   if k != "le"))
                p = by_tags.setdefault(key, {
                    "bounds": [], "counts": [], "sum": 0.0, "count": 0,
                    "tags": {k: v for k, v in key}})
                if name.endswith("_sum"):
                    p["sum"] = value
                elif name.endswith("_count"):
                    p["count"] = int(value)
                elif le is not None:
                    p["bounds"].append(le)
                    p["counts"].append(int(value))
            points = []
            for p in by_tags.values():
                finite = [float(b) for b in p["bounds"] if b != "+Inf"]
                # Cumulative bucket counts -> per-bucket (OTLP shape).
                cum = p["counts"]
                per = [cum[0]] + [cum[i] - cum[i - 1]
                                  for i in range(1, len(cum))] if cum \
                    else []
                points.append({
                    "attributes": attrs(p["tags"]),
                    "timeUnixNano": str(now_ns),
                    "count": str(p["count"]), "sum": p["sum"],
                    "explicitBounds": finite, "bucketCounts":
                        [str(c) for c in per]})
            base["histogram"] = {"dataPoints": points,
                                 "aggregationTemporality": 2}
        else:
            points = [{"attributes": attrs(tags),
                       "timeUnixNano": str(now_ns),
                       "asDouble": float(value)}
                      for _n, tags, value in snap["samples"]]
            if mtype == "counter":
                base["sum"] = {"dataPoints": points, "isMonotonic": True,
                               "aggregationTemporality": 2}
            else:
                base["gauge"] = {"dataPoints": points}
        otlp_metrics.append(base)

    doc = {"resourceMetrics": [{
        "resource": {"attributes": [{
            "key": "service.name",
            "value": {"stringValue": "ray_tpu"}}]},
        "scopeMetrics": [{"scope": {"name": "ray_tpu.util.metrics"},
                          "metrics": otlp_metrics}],
    }]}
    with open(path, "w") as f:
        json.dump(doc, f)
    return path
