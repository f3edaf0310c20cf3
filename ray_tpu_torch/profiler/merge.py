"""Merge per-process capture records into one Chrome-trace/Perfetto JSON
(a copy of ray_tpu/profiler/merge.py, with the torch window's events
folded in).

Reference: python/ray/_private/state.py:471 (chrome_tracing_dump) — same
output dialect (trace-event JSON, ``ph: X`` complete events + ``ph: M``
metadata), loadable in chrome://tracing, Perfetto and speedscope.

Every record's events are shifted by its ``clock_offset_s`` so the whole
trace sits on the DRIVER's clock: a slice at t on actor A and a slice at
t on actor B happened at the same driver-observed instant, which is what
makes cross-process straggler analysis readable.  A record's
``torch.profiler`` events (CPU ops, CUDA runtime calls, kernels; capture.py
puts them on its process's wall clock) are shifted the same way and land
under the same process, each on a ``torch <tid>`` thread row: the port
writes them into the merged trace itself, where JAX writes its profiler's
TensorBoard artifacts beside the trace (``write_jax_artifacts``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional


def _slices_for_record(rec: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Fold a record's stack samples into trace slices: consecutive
    samples of one thread with the same leaf frame coalesce into one
    ``X`` event named by that leaf (a poor man's flame timeline)."""
    events: List[Dict[str, Any]] = []
    offset = rec.get("clock_offset_s") or 0.0
    period = 1.0 / max(1.0, rec.get("hz") or 67.0)
    pid = _process_label(rec)
    events.append({"ph": "M", "name": "process_name", "pid": pid,
                   "tid": 0, "args": {"name": pid}})
    # thread ident -> (leaf, start_wall, last_wall, stack, name)
    open_slices: Dict[int, List[Any]] = {}

    def close(tid: int) -> None:
        leaf, start, last, stack, name = open_slices.pop(tid)
        events.append({
            "name": leaf, "cat": "sample", "ph": "X",
            "ts": (start - offset) * 1e6,
            "dur": max(period, last - start + period) * 1e6,
            "pid": pid, "tid": f"{name} ({tid})",
            "args": {"stack": stack},
        })

    for sample in rec.get("samples", ()):
        t = sample["t"]
        threads = sample.get("threads", {})
        for tid in list(open_slices):
            cur = open_slices[tid]
            new = threads.get(tid)
            # A gap (thread died / sampler stalled) or a leaf change
            # closes the slice.
            if new is None or new["leaf"] != cur[0] \
                    or t - cur[2] > 4 * period:
                close(tid)
        for tid, th in threads.items():
            if tid in open_slices:
                open_slices[tid][2] = t
            else:
                open_slices[tid] = [th["leaf"], t, t,
                                    list(th.get("stack", ())),
                                    th.get("name", f"t{tid}")]
    for tid in list(open_slices):
        close(tid)
    return events


def _torch_events_for_record(rec: Dict[str, Any]) -> List[Dict[str, Any]]:
    """A record's torch.profiler events on the driver's clock, under the
    record's process."""
    blob = (rec.get("torch_profile") or {}).get("events")
    if not blob:
        return []
    offset = rec.get("clock_offset_s") or 0.0
    pid = _process_label(rec)
    out = []
    for e in json.loads(blob):
        ev = {"name": e["name"], "cat": e["cat"], "ph": e["ph"],
              "ts": e["ts"] - offset * 1e6, "pid": pid,
              "tid": f"torch {e.get('tid', 0)}"}
        if "dur" in e:
            ev["dur"] = e["dur"]
        if e["ph"] == "i":
            ev["s"] = "t"
        out.append(ev)
    return out


def _process_label(rec: Dict[str, Any]) -> str:
    who = "driver" if rec.get("is_driver") \
        else f"worker:{(rec.get('worker_id') or '?')[:8]}"
    return f"{who} pid={rec.get('pid')}"


def merge_records(records: List[Dict[str, Any]],
                  timeline_events: Optional[List[Dict[str, Any]]] = None,
                  window: Optional[tuple] = None,
                  meta: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Build the merged Chrome-trace document.

    ``records`` are capture_profile outputs (driver + workers);
    ``timeline_events`` are the driver's existing chrome_trace events
    (profile spans, task slices) — filtered to ``window`` (wall seconds,
    driver clock) so the on-demand capture carries the framework's own
    span context for the same interval.
    """
    events: List[Dict[str, Any]] = []
    processes: List[Dict[str, Any]] = []
    for rec in records:
        if rec.get("error"):
            processes.append({"worker_id": rec.get("worker_id"),
                              "pid": rec.get("pid"),
                              "error": rec["error"]})
            continue
        events.extend(_slices_for_record(rec))
        torch_events = _torch_events_for_record(rec)
        events.extend(torch_events)
        tp = rec.get("torch_profile") or {}
        processes.append({
            "worker_id": rec.get("worker_id"),
            "pid": rec.get("pid"),
            "is_driver": bool(rec.get("is_driver")),
            "clock_offset_s": rec.get("clock_offset_s"),
            "num_samples": len(rec.get("samples", ())),
            "torch_profile": {
                "attempted": tp.get("attempted"),
                "cuda": tp.get("cuda"),
                "num_events": len(torch_events),
                "bytes": tp.get("bytes", 0),
                "error": tp.get("error"),
                "seconds": tp.get("seconds", {}),
            },
            "memory": rec.get("memory", []),
        })
    if timeline_events:
        lo = (window[0] * 1e6) if window else None
        hi = (window[1] * 1e6) if window else None
        for ev in timeline_events:
            ts = ev.get("ts")
            if ts is None:
                continue
            if lo is not None and (ts + ev.get("dur", 0.0) < lo
                                   or ts > hi):
                continue
            events.append(ev)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": dict(meta or {}, processes=processes),
    }


def write_trace(path: str, doc: Dict[str, Any]) -> str:
    """Publish the merged trace atomically (tmp + rename: a reader —
    the dashboard, a human mid-download — never sees a torn file)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return path
