"""Bounded scheduler decision ring (the control-plane flight recorder; a
copy of ``ray_tpu/schedview/decisions.py``).

Reference analog: the GCS task-event buffer keeps task STATE transitions
(src/ray/gcs/gcs_task_manager.h:97); nothing in the reference keeps the
scheduler's DECISIONS — the autoscaler reconstructs demand from resource
shapes instead.  Here every ``_try_place``/``_hybrid_pick``/PG-commit
outcome lands in one bounded ring on the head, so "why is this pending"
and "why node X" are point lookups, not log archaeology.

Hot-path contract: recording is ONE ``deque.append`` of a tuple plus an
integer bump — no locks, no dict churn, no string formatting.  Folding
tuples into the per-task "latest decision" index happens lazily at read
time (same batching idiom as ``_private/events.py``), and everything
stringy (scheduling-class reprs, node hex) is produced at snapshot time.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional

# -- rejection reason codes (closed vocabulary) -----------------------------
#
# Every rejected placement is tallied under one of these; `ray-tpu task
# why`, state.explain_task() and the bench's saturation-phase assertions
# all match on them, so additions here must ride a README update.
R_INSUFFICIENT = "insufficient_resources"  # node alive but lacks capacity NOW
R_DRAINING = "draining"                    # drain fence excluded the node
R_AFFINITY = "affinity_miss"               # hard NodeAffinity target unusable
R_BUNDLE = "bundle_unavailable"            # PG bundle not committed / full
R_INFEASIBLE = "infeasible"                # no node could EVER satisfy it
R_PENDING_DEPS = "pending_deps"            # upstream ObjectIDs unresolved
R_NO_NODES = "no_nodes"                    # empty cluster

REASON_CODES = (R_INSUFFICIENT, R_DRAINING, R_AFFINITY, R_BUNDLE,
                R_INFEASIBLE, R_PENDING_DEPS, R_NO_NODES)

# Decision kinds (what produced the record).
K_INLINE = "inline"        # submit-time fast-path placement
K_LOOP = "loop"            # scheduler-loop placement
K_EXCHANGE = "exchange"    # lease reuse (finished task's booking handed on)
K_PIPELINE = "pipeline"    # queued ahead on a busy worker (no booking)
K_REJECT = "reject"        # a ready class failed to place this round
K_INFEASIBLE = "infeasible"  # parked: no node could ever satisfy it
K_PG_COMMIT = "pg_commit"  # placement-group two-phase commit succeeded
K_PG_REJECT = "pg_reject"  # placement-group prepare found no assignment

# -- global enable switch ---------------------------------------------------

_enabled = os.environ.get("RAY_TPU_SCHED_TRACE", "1").strip().lower() \
    not in ("0", "false", "no", "off")


def enabled() -> bool:
    """Whether scheduler decision tracing is on (module-global: one
    read on the submit path)."""
    return _enabled


def set_enabled(value: bool) -> None:
    """Toggle decision tracing (the control_plane bench's off/on
    overhead reps; operators use RAY_TPU_SCHED_TRACE=0)."""
    global _enabled
    _enabled = bool(value)


def _class_str(key: Any) -> str:
    """Human-readable scheduling-class key (resources + strategy); the
    raw key holds ID objects, so stringification is snapshot-time only.
    ``res`` may be an items-tuple (the scheduler's class key) or a
    ResourceSet (hot-path success records skip the sorted-key build)."""
    if isinstance(key, str):  # PG records carry the strategy name
        return key
    try:
        res, pg, bundle, strat = key
        if hasattr(res, "to_dict"):
            res = res.to_dict().items()
        parts = [",".join(f"{k}:{v:g}" for k, v in res) or "no-resources"]
        if pg is not None:
            parts.append(f"pg={pg.hex()[:8]}b{bundle}")
        if strat is not None:
            if isinstance(strat, tuple) and strat and strat[0] == "affinity":
                parts.append(f"affinity={strat[1].hex()[:8]}"
                             f"{'~' if strat[2] else ''}")
            else:
                parts.append(str(strat))
        return " ".join(parts)
    except Exception:  # noqa: BLE001 — display-only
        return repr(key)


class DecisionRing:
    """Bounded, lazily-folded ring of scheduler decision records.

    ``push`` is on the per-decision hot path; it appends a raw tuple
    ``(mono, wall, kind, task_id_hex, name, class_key, candidates,
    rejected, node_hex, attempt)`` and bumps a plain int counter.  The
    per-task latest-decision index (what ``explain`` reads) is built at
    fold time under the ring lock.
    """

    def __init__(self, capacity: int = 4096):
        self.capacity = max(64, int(capacity))
        self._pending: deque = deque()
        self._records: deque = deque()
        self._latest: "OrderedDict[str, tuple]" = OrderedDict()
        self._lock = threading.Lock()
        self.num_dropped = 0
        # Plain-int per-kind totals (flushed into the telemetry counter
        # by the scheduler's rate-limited publisher, never on hot path).
        self.counts: Dict[str, int] = {}
        self._fold_at = max(256, self.capacity // 2)

    # -- hot path -----------------------------------------------------------

    def push(self, kind: str, task_id_hex: Optional[str], name: str,
             class_key: Any, candidates: int,
             rejected: Optional[Dict[str, int]], node_hex: Optional[str],
             attempt: int) -> None:
        # One clock read per decision: records carry the monotonic stamp
        # only, and snapshot() maps mono->wall through a single offset
        # computed at read time.
        # Documented lock-free hot path: deque.append is thread-safe and
        # _fold() drains under the lock; counts is written only by the
        # scheduler loop (single writer) and read advisorily.
        self._pending.append((time.monotonic(), kind,  # ray-tpu: noqa[RT401]
                              task_id_hex, name, class_key, candidates,
                              rejected, node_hex, attempt))
        self.counts[kind] = self.counts.get(kind, 0) + 1  # ray-tpu: noqa[RT401]
        if len(self._pending) >= self._fold_at:
            self._fold()

    # -- folding / reads ----------------------------------------------------

    def _fold(self) -> None:
        with self._lock:
            while True:
                try:
                    rec = self._pending.popleft()
                except IndexError:
                    break
                self._records.append(rec)
                if len(self._records) > self.capacity:
                    self._records.popleft()
                    self.num_dropped += 1
                tid = rec[2]
                if tid is not None:
                    self._latest[tid] = rec
                    self._latest.move_to_end(tid)
                    if len(self._latest) > self.capacity:
                        self._latest.popitem(last=False)

    @staticmethod
    def _to_dict(rec: tuple,
                 wall_offset: Optional[float] = None) -> Dict[str, Any]:
        (mono, kind, tid, name, key, candidates, rejected, node,
         attempt) = rec
        if wall_offset is None:
            # Not an interval: the one-off mono->wall basis shift for
            # display (records carry only the monotonic stamp).
            wall_offset = time.time() - time.monotonic()  # ray-tpu: noqa[RT203]
        return {
            "time": mono + wall_offset, "mono": mono, "kind": kind,
            "task_id": tid,
            "name": name, "sched_class": _class_str(key),
            "candidates": candidates, "rejected": dict(rejected or {}),
            "node_id": node, "attempt": attempt,
        }

    def snapshot(self, task_id: Optional[str] = None,
                 limit: int = 200) -> List[Dict[str, Any]]:
        """Newest-last decision records; ``task_id`` filters (prefix ok:
        operators paste truncated ids)."""
        self._fold()
        out: List[Dict[str, Any]] = []
        # Mono->wall basis shift for display, not an interval.
        wall_offset = time.time() - time.monotonic()  # ray-tpu: noqa[RT203]
        with self._lock:
            records = list(self._records)
        for rec in reversed(records):
            if task_id is not None and \
                    not (rec[2] or "").startswith(task_id):
                continue
            out.append(self._to_dict(rec, wall_offset))
            if len(out) >= limit:
                break
        out.reverse()
        return out

    def latest_for(self, task_id: str) -> Optional[Dict[str, Any]]:
        """The newest decision recorded for one task (exact id)."""
        self._fold()
        with self._lock:
            rec = self._latest.get(task_id)
        return self._to_dict(rec) if rec is not None else None

    def rate(self, window_s: float = 5.0) -> float:
        """Decisions/s over the trailing window (bounded by ring
        capacity — a saturated ring under-reports, which num_dropped
        makes visible)."""
        self._fold()
        cutoff = time.monotonic() - window_s
        with self._lock:
            n = sum(1 for rec in reversed(self._records)
                    if rec[0] >= cutoff)
        return n / window_s if window_s > 0 else 0.0

    def stats(self) -> Dict[str, Any]:
        self._fold()
        with self._lock:
            size = len(self._records)
        # Advisory snapshot: slightly-stale counters are fine for stats.
        return {"counts": dict(self.counts),
                "total": sum(self.counts.values()),
                "size": size, "capacity": self.capacity,
                "num_dropped": self.num_dropped}  # ray-tpu: noqa[RT401]

    def clear(self) -> None:
        with self._lock:
            self._pending.clear()
            self._records.clear()
            self._latest.clear()
            self.counts = {}
            self.num_dropped = 0
