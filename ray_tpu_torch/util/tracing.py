"""Distributed tracing: W3C trace contexts propagated through task and
actor-call submission (a copy of ray_tpu/util/tracing.py).

A context is a ``SpanContext`` (a 32-hex trace id and a 16-hex span id),
carried as the W3C ``traceparent`` string
(``00-<trace_id:32hex>-<span_id:16hex>-01``):

  * ``enable()`` on the driver turns on submit spans; every ``.remote()``
    of a task or an actor method records a ``submit`` span and stamps the
    child context into what it sends (``submit_span``).
  * The task worker or actor sees the context, records an ``execute``
    span and installs it as the current context (``task_span``) — nested
    ``.remote()`` calls inherit it, so the whole cascade shares one trace
    id.
  * The serving routers allocate a request's root context at submit
    (``new_child``) and record each pipeline phase as it ends
    (``record_span``), from whichever thread finishes it.

The JAX package routes spans to its cluster's driver over its control
channel; here a worker's or actor's finished spans travel back with the
task's result or ahead of the call's reply, into the calling process's
bounded table.  ``get_trace`` returns one trace, ``render_trace`` a
textual tree, and ``export_otlp_json`` writes the OTLP/JSON shape for
offline import (file export only).  With tracing off (the default) and no
ambient context, nothing is recorded.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Any, Dict, List, Optional

_tls = threading.local()
_enabled = False
#: Spans kept, oldest dropped first.
MAX_SPANS = 100_000
_lock = threading.Lock()
_spans: "collections.deque" = collections.deque(maxlen=MAX_SPANS)


def _rand_hex(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


class SpanContext:
    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-01"

    @staticmethod
    def from_traceparent(tp: str) -> Optional["SpanContext"]:
        try:
            _ver, trace_id, span_id, _flags = tp.split("-")
            if len(trace_id) == 32 and len(span_id) == 16:
                return SpanContext(trace_id, span_id)
        except ValueError:
            pass
        return None


def enable() -> None:
    """Turn on tracing in this process: requests with no ambient context
    start a trace of their own."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def is_enabled() -> bool:
    return _enabled


def current() -> Optional[SpanContext]:
    return getattr(_tls, "ctx", None)


def set_current(ctx: Optional[SpanContext]) -> None:
    _tls.ctx = ctx


def _record(span: Dict[str, Any]) -> None:
    with _lock:
        _spans.append(span)


def _record_many(spans: List[Dict[str, Any]]) -> None:
    """Spans finished in another process (a task's worker, an actor)."""
    with _lock:
        _spans.extend(spans)


def _drain() -> List[Dict[str, Any]]:
    """Take every recorded span out of this process's table (a task
    worker or an actor, to send them to the caller)."""
    with _lock:
        out = list(_spans)
        _spans.clear()
    return out


def submit_span(task_name: str, task_id_hex: str) -> Optional[str]:
    """Caller side of ``.remote()``: record a submit span and return the
    traceparent to send along (None when tracing is off and no ambient
    context exists)."""
    parent = current()
    if not _enabled and parent is None:
        return None
    trace_id = parent.trace_id if parent else _rand_hex(16)
    span_id = _rand_hex(8)
    now = time.time()
    _record({
        "trace_id": trace_id, "span_id": span_id,
        "parent_span_id": parent.span_id if parent else None,
        "name": f"submit {task_name}", "kind": "PRODUCER",
        "start_s": now, "end_s": now,
        "attributes": {"task_id": task_id_hex, "op": "submit"},
    })
    return SpanContext(trace_id, span_id).traceparent()


class task_span:
    """Executor-side context manager around a task or an actor call:
    records the execute span and installs the context so nested submits
    nest."""

    def __init__(self, traceparent: Optional[str], task_name: str,
                 task_id_hex: str):
        self._parent = SpanContext.from_traceparent(traceparent) \
            if traceparent else None
        self._name = task_name
        self._task_id = task_id_hex
        self._prev = None
        self._ctx = None
        self._t0 = 0.0
        self._t0_mono = 0.0

    def __enter__(self):
        if self._parent is None:
            return self
        self._prev = current()
        self._ctx = SpanContext(self._parent.trace_id, _rand_hex(8))
        set_current(self._ctx)
        # Wall clock anchors the span; duration is monotonic so an NTP
        # step during execution can't produce a negative span.
        self._t0 = time.time()
        self._t0_mono = time.monotonic()
        return self

    def __exit__(self, exc_type, _exc, _tb):
        if self._parent is None:
            return False
        set_current(self._prev)
        _record({
            "trace_id": self._ctx.trace_id, "span_id": self._ctx.span_id,
            "parent_span_id": self._parent.span_id,
            "name": f"execute {self._name}", "kind": "CONSUMER",
            "start_s": self._t0,
            "end_s": self._t0 + (time.monotonic() - self._t0_mono),
            "attributes": {"task_id": self._task_id, "op": "execute",
                           "error": exc_type.__name__ if exc_type else None},
        })
        return False


def record_span(parent: Optional[SpanContext], name: str,
                start_s: float, end_s: float,
                attributes: Optional[Dict[str, Any]] = None,
                kind: str = "INTERNAL",
                ctx: Optional[SpanContext] = None) -> Optional[SpanContext]:
    """Record one finished span with explicit parent linkage and return its
    context (None when tracing is off and no parent exists).

    The cross-thread form: pipeline stages that finish on another thread
    than the one that opened the request carry the parent ``SpanContext``
    in their request state and record phases as they complete."""
    if ctx is None:
        # An explicit ctx means the trace is already in flight (allocated
        # while tracing was on): record it even if tracing was turned off
        # meanwhile; otherwise the usual gate applies.
        if parent is None and not _enabled:
            return None
        ctx = SpanContext(parent.trace_id if parent else _rand_hex(16),
                          _rand_hex(8))
    _record({
        "trace_id": ctx.trace_id, "span_id": ctx.span_id,
        "parent_span_id": parent.span_id if parent else None,
        "name": name, "kind": kind,
        "start_s": start_s, "end_s": end_s,
        "attributes": attributes or {},
    })
    return ctx


def new_child(parent: Optional[SpanContext]) -> Optional[SpanContext]:
    """Allocate a child span context NOW (so sub-spans can parent onto it)
    for a span whose end, and so whose record, comes later.  Pair with
    ``record_span(..., ctx=child)``."""
    if parent is None and not _enabled:
        return None
    return SpanContext(parent.trace_id if parent else _rand_hex(16),
                       _rand_hex(8))


class span:
    """In-thread span context manager: child of the current context,
    installed as current for the duration (nested spans and ``.remote``
    submits inside the block join the same trace)::

        with tracing.span("serve_route", {"deployment": name}):
            ...
    """

    def __init__(self, name: str,
                 attributes: Optional[Dict[str, Any]] = None,
                 kind: str = "INTERNAL"):
        self._name = name
        self._attrs = attributes
        self._kind = kind
        self._ctx: Optional[SpanContext] = None
        self._prev: Optional[SpanContext] = None
        self._t0 = 0.0
        self._t0_mono = 0.0

    def __enter__(self) -> "span":
        parent = current()
        self._ctx = new_child(parent)
        if self._ctx is None:
            return self
        self._prev = parent
        set_current(self._ctx)
        self._t0 = time.time()
        self._t0_mono = time.monotonic()
        return self

    def __exit__(self, exc_type, _exc, _tb) -> bool:
        if self._ctx is None:
            return False
        set_current(self._prev)
        attrs = dict(self._attrs or {})
        if exc_type is not None:
            attrs["error"] = exc_type.__name__
        record_span(self._prev, self._name, self._t0,
                    self._t0 + (time.monotonic() - self._t0_mono),
                    attrs, self._kind, ctx=self._ctx)
        return False


# -- consumption ----------------------------------------------------------- #

def get_trace(trace_id: str) -> List[Dict[str, Any]]:
    """All recorded spans of one trace, start-ordered."""
    with _lock:
        spans = [dict(s) for s in _spans if s["trace_id"] == trace_id]
    return sorted(spans, key=lambda s: s["start_s"])


def list_traces() -> List[str]:
    """Trace ids with at least one recorded span, oldest first."""
    with _lock:
        return list(dict.fromkeys(s["trace_id"] for s in _spans))


def render_trace(trace_id: str) -> str:
    """Textual tree of one trace (parent/child by span ids)."""
    spans = get_trace(trace_id)
    by_parent: Dict[Optional[str], List[Dict[str, Any]]] = {}
    for s in spans:
        by_parent.setdefault(s.get("parent_span_id"), []).append(s)
    lines: List[str] = [f"trace {trace_id}"]

    def walk(parent_id, depth):
        for s in by_parent.get(parent_id, ()):
            dur_ms = (s["end_s"] - s["start_s"]) * 1e3
            lines.append("  " * depth + f"- {s['name']} "
                         f"[{s['span_id']}] {dur_ms:.1f}ms")
            walk(s["span_id"], depth + 1)

    walk(None, 1)
    return "\n".join(lines)


def export_otlp_json(path: str, trace_id: Optional[str] = None) -> str:
    """Write spans (one trace's, or all) in the OTLP/JSON resource-spans
    shape (importable by OTel-compatible tools; file export only)."""
    import json

    with _lock:
        spans = [dict(s) for s in _spans
                 if trace_id is None or s["trace_id"] == trace_id]
    otlp = {
        "resourceSpans": [{
            "resource": {"attributes": [
                {"key": "service.name",
                 "value": {"stringValue": "ray_tpu"}}]},
            "scopeSpans": [{
                "scope": {"name": "ray_tpu.tracing"},
                "spans": [{
                    "traceId": s["trace_id"],
                    "spanId": s["span_id"],
                    "parentSpanId": s.get("parent_span_id") or "",
                    "name": s["name"],
                    "kind": 4 if s["kind"] == "PRODUCER" else 5,
                    "startTimeUnixNano": int(s["start_s"] * 1e9),
                    "endTimeUnixNano": int(s["end_s"] * 1e9),
                    "attributes": [
                        {"key": k, "value": {"stringValue": str(v)}}
                        for k, v in (s.get("attributes") or {}).items()
                        if v is not None],
                } for s in spans],
            }],
        }],
    }
    with open(path, "w") as f:
        json.dump(otlp, f)
    return path


def _reset_for_tests() -> None:
    disable()
    with _lock:
        _spans.clear()
