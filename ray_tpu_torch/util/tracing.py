"""Request tracing: W3C trace contexts and the spans recorded under them (a
copy of the part of ray_tpu/util/tracing.py that the serving routers use).

A context is a ``SpanContext`` (a 32-hex trace id and a 16-hex span id,
W3C's traceparent fields).  The routers allocate a request's root context at submit
(``new_child``) and record each pipeline phase as it ends (``record_span``),
from whichever thread finishes it, so queue wait, prefill, KV handoff and
decode admission land in one trace tree.

The JAX package routes spans to its cluster's driver; the port has no
cluster runtime, so spans go to this process's bounded table, read by
``get_trace`` and ``list_traces``.  With tracing off (the default) and no
ambient context, nothing is recorded.
"""

from __future__ import annotations

import collections
import os
import threading
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


def enable() -> None:
    """Turn on tracing in this process: requests with no ambient context
    start a trace of their own."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def current() -> Optional[SpanContext]:
    return getattr(_tls, "ctx", None)


def set_current(ctx: Optional[SpanContext]) -> None:
    _tls.ctx = ctx


def _record(span: Dict[str, Any]) -> None:
    with _lock:
        _spans.append(span)


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


def get_trace(trace_id: str) -> List[Dict[str, Any]]:
    """All recorded spans of one trace, start-ordered."""
    with _lock:
        spans = [dict(s) for s in _spans if s["trace_id"] == trace_id]
    return sorted(spans, key=lambda s: s["start_s"])


def list_traces() -> List[str]:
    """Trace ids with at least one recorded span, oldest first."""
    with _lock:
        return list(dict.fromkeys(s["trace_id"] for s in _spans))


def _reset_for_tests() -> None:
    disable()
    with _lock:
        _spans.clear()
