"""Task lifecycle events for the state API and the timeline (a copy of
``ray_tpu/_private/events.py``).

``TaskEventBuffer`` is one bounded buffer in the head's runtime
(``_runtime.Runtime.events``): every task's transitions land there, those
of tasks run on a node's workers too (the node reports a task's start and
its end up to the head), so the state names below are what the timeline
and ``schedview``'s stage attribution read.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .schedview.decisions import enabled as _sched_trace_enabled

# Task states, mirroring the reference's TaskStatus enum (common.proto),
# plus the two scheduler-internal stages the schedview lifecycle
# attribution adds (deps resolved -> ready queue; placement booked).
PENDING_ARGS = "PENDING_ARGS_AVAIL"
READY = "READY"
PLACED = "PLACED"
SUBMITTED_TO_NODE = "SUBMITTED_TO_WORKER"
RUNNING = "RUNNING"
FINISHED = "FINISHED"
FAILED = "FAILED"

# Stage-wait label per ARRIVING state: the wait is monotonic-minus-
# monotonic against the previous recorded transition of the same task
# (never wall-clock arithmetic — the RT203 class), published as
# ray_tpu_sched_stage_wait_seconds{stage=...}.
_STAGE_LABEL = {
    READY: "deps",               # submit -> deps resolved / ready
    PLACED: "queue",             # ready -> placement booked
    SUBMITTED_TO_NODE: "dispatch",  # placed -> shipped to a node
    RUNNING: "startup",          # dispatched -> executing
    FINISHED: "run",             # running -> done
    FAILED: "run",
}


@dataclass
class TaskEvent:
    task_id: str
    name: str
    state: str = PENDING_ARGS
    type: str = "NORMAL_TASK"  # NORMAL_TASK | ACTOR_CREATION_TASK | ACTOR_TASK
    actor_id: Optional[str] = None
    node_id: Optional[str] = None
    worker_id: Optional[str] = None
    error_message: Optional[str] = None
    # state -> unix seconds of first entry into that state
    state_times: Dict[str, float] = field(default_factory=dict)
    # stage label -> seconds waited entering that stage (monotonic
    # deltas folded from the per-record mono stamps; see _STAGE_LABEL)
    stage_waits: Dict[str, float] = field(default_factory=dict)
    # Monotonic stamp of the last folded transition (not serialized).
    last_mono: Optional[float] = field(default=None, repr=False)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "task_id": self.task_id, "name": self.name, "state": self.state,
            "type": self.type, "actor_id": self.actor_id,
            "node_id": self.node_id, "worker_id": self.worker_id,
            "error_message": self.error_message,
            "state_times": dict(self.state_times),
            "stage_waits": dict(self.stage_waits),
        }


@dataclass
class ProfileSpan:
    """A user/system span for the chrome-trace timeline."""
    name: str
    category: str
    start_s: float
    end_s: float
    pid: str  # row group (node / component)
    tid: str  # row (worker / thread)
    extra: Optional[Dict[str, Any]] = None


class TaskEventBuffer:
    """Bounded, insertion-ordered task event history (oldest evicted).

    ``record`` is on the per-task dispatch path (4 transitions per task),
    so it only appends a tuple to a deque — folding transitions into
    per-task TaskEvent state happens lazily at read time (reference:
    task_event_buffer.h batches transitions and ships them OFF the task
    path for the same reason)."""

    def __init__(self, max_events: int = 10000):
        self._max = max_events
        self._events: "OrderedDict[str, TaskEvent]" = OrderedDict()
        self._spans: List[ProfileSpan] = []
        self._lock = threading.Lock()
        self.num_dropped = 0
        from collections import deque
        self._pending: "deque" = deque()
        self._fold_at = max(1000, min(max_events * 2, 100_000))

    def record(self, task_id: str, state: str, *, name: Optional[str] = None,
               task_type: Optional[str] = None, actor_id: Optional[str] = None,
               node_id: Optional[str] = None, worker_id: Optional[str] = None,
               error_message: Optional[str] = None) -> None:
        # deque.append is thread-safe; no lock on the hot path.  ONE
        # clock read: records carry the monotonic stamp (stage waits
        # are mono-minus-mono, so an NTP step between two transitions
        # can never mint a negative/garbage latency) and the fold maps
        # mono->wall through a per-batch offset for state_times.
        # Safe bare access: deque.append is thread-safe by design (the
        # documented lock-free hot path above); _lock only guards folds.
        self._pending.append((task_id, state,  # ray-tpu: noqa[RT401]
                              time.monotonic(),
                              name, task_type, actor_id, node_id, worker_id,
                              error_message))
        if len(self._pending) >= self._fold_at:
            self._fold()

    def _fold(self) -> None:
        waits: list = []
        # Stage waits are only derived while tracing is on: with the
        # scheduler's READY/PLACED stamps disabled, the delta into
        # SUBMITTED would silently absorb queue+deps wait and point an
        # operator at dispatch when the bottleneck was placement.
        trace = _sched_trace_enabled()
        # Mono->wall basis shift for this batch's display stamps, not
        # an interval.
        wall_offset = time.time() - time.monotonic()  # ray-tpu: noqa[RT203]
        with self._lock:
            while True:
                try:
                    (task_id, state, mono, name, task_type, actor_id,
                     node_id, worker_id, error_message) = \
                        self._pending.popleft()
                except IndexError:
                    break
                now = mono + wall_offset
                ev = self._events.get(task_id)
                if ev is None:
                    ev = TaskEvent(task_id=task_id, name=name or "")
                    self._events[task_id] = ev
                    if len(self._events) > self._max:
                        self._events.popitem(last=False)
                        self.num_dropped += 1
                if name:
                    ev.name = name
                if task_type:
                    ev.type = task_type
                if actor_id:
                    ev.actor_id = actor_id
                if node_id:
                    ev.node_id = node_id
                if worker_id:
                    ev.worker_id = worker_id
                if error_message is not None:
                    ev.error_message = error_message
                ev.state = state
                ev.state_times.setdefault(state, now)
                if trace:
                    stage = _STAGE_LABEL.get(state)
                    if stage is not None and ev.last_mono is not None:
                        dt = max(0.0, mono - ev.last_mono)
                        ev.stage_waits[stage] = \
                            ev.stage_waits.get(stage, 0.0) + dt
                        waits.append((stage, dt))
                ev.last_mono = mono
        # Histogram publication happens OUTSIDE the buffer lock (the
        # metrics registry has its own) and BATCHED per stage — one
        # tag-key/lock cycle per fold, not five per task.  Gated by the
        # same switch as the decision ring so the control_plane bench's
        # off/on overhead reps toggle the whole addition.
        if waits:
            from ray_tpu_torch.util import telemetry
            by_stage: Dict[str, list] = {}
            for stage, dt in waits:
                by_stage.setdefault(stage, []).append(dt)
            for stage, vals in by_stage.items():
                telemetry.observe_many("ray_tpu_sched_stage_wait_seconds",
                                       vals, tags={"stage": stage})

    def add_span(self, span: ProfileSpan) -> None:
        with self._lock:
            self._spans.append(span)
            if len(self._spans) > self._max:
                self._spans = self._spans[-self._max:]

    def snapshot(self, filters: Optional[Dict[str, Any]] = None,
                 limit: int = 10000, stage: Optional[str] = None,
                 min_stage_wait_s: Optional[float] = None
                 ) -> List[Dict[str, Any]]:
        """Filtered task records, newest-``limit`` in insertion order.

        Filters are pushed below the dict materialization and the scan
        walks newest-first with an early exit, so a point lookup
        (``state.get_task``) touches O(limit) records even when the ring
        holds the 10k-node bench's full task table.  ``stage`` +
        ``min_stage_wait_s`` select tasks by lifecycle-stage latency
        (e.g. every task that waited >1s in ``queue``)."""
        if limit <= 0:
            return []
        self._fold()
        out: List[Dict[str, Any]] = []
        with self._lock:
            for ev in reversed(self._events.values()):
                if filters:
                    rec = ev.to_dict()
                    if any(rec.get(k) != v for k, v in filters.items()):
                        continue
                else:
                    rec = None
                if stage is not None:
                    wait = ev.stage_waits.get(stage)
                    if wait is None or (min_stage_wait_s is not None
                                        and wait < min_stage_wait_s):
                        continue
                out.append(rec if rec is not None else ev.to_dict())
                if len(out) >= limit:
                    break
        out.reverse()
        return out

    def summary(self, states: Optional[List[str]] = None,
                limit: Optional[int] = None) -> Dict[str, Dict[str, int]]:
        """name -> state -> count (reference: util/state summarize_tasks).

        ``states`` restricts to tasks currently in one of those states;
        ``limit`` caps the scan to the newest N records — both applied
        server-side so summaries stay cheap at bench scale."""
        self._fold()
        out: Dict[str, Dict[str, int]] = {}
        scanned = 0
        with self._lock:
            for ev in reversed(self._events.values()):
                if limit is not None and scanned >= limit:
                    break
                scanned += 1
                if states is not None and ev.state not in states:
                    continue
                per = out.setdefault(ev.name or "<unnamed>", {})
                per[ev.state] = per.get(ev.state, 0) + 1
        return out

    def find_ids(self, prefix: str, limit: int = 8) -> List[str]:
        """Task ids starting with ``prefix``, newest first (operators
        paste truncated ids into `ray-tpu task why`)."""
        self._fold()
        out: List[str] = []
        with self._lock:
            for tid in reversed(self._events):
                if tid.startswith(prefix):
                    out.append(tid)
                    if len(out) >= limit:
                        break
        return out

    def stats(self) -> Dict[str, int]:
        """Buffer health: ring saturation under load must be VISIBLE
        (a silently clipped history reads as 'no pending tasks').

        ``fold_backlog`` is sampled BEFORE the fold this read performs:
        it reports how many raw transitions had accumulated since the
        last fold (fold pressure), while ``num_events``/``num_dropped``
        are accurate post-fold."""
        backlog = len(self._pending)
        self._fold()
        with self._lock:
            return {"num_events": len(self._events),
                    "capacity": self._max,
                    "num_dropped": self.num_dropped,
                    "fold_backlog": backlog}

    def chrome_trace(self) -> List[Dict[str, Any]]:
        """Chrome trace-event JSON (``ph: X`` complete events), one row per
        worker, one group per node — loadable in chrome://tracing and
        Perfetto (reference: _private/state.py:471 chrome_tracing_dump)."""
        trace: List[Dict[str, Any]] = []
        self._fold()
        with self._lock:
            events = list(self._events.values())
            spans = list(self._spans)
        for ev in events:
            start = ev.state_times.get(RUNNING)
            if start is None:
                continue
            end = (ev.state_times.get(FINISHED)
                   or ev.state_times.get(FAILED) or time.time())
            trace.append({
                "name": ev.name, "cat": "task", "ph": "X",
                "ts": start * 1e6, "dur": max(0.0, (end - start)) * 1e6,
                "pid": f"node:{(ev.node_id or 'driver')[:8]}",
                "tid": f"worker:{(ev.worker_id or '?')[:8]}",
                "args": {"task_id": ev.task_id, "state": ev.state},
            })
            # Queueing time as a lighter-weight slice.
            sub = ev.state_times.get(PENDING_ARGS)
            if sub is not None and start > sub:
                trace.append({
                    "name": f"{ev.name} (queued)", "cat": "scheduler",
                    "ph": "X", "ts": sub * 1e6, "dur": (start - sub) * 1e6,
                    "pid": "scheduler", "tid": "queue",
                    "args": {"task_id": ev.task_id},
                })
        for sp in spans:
            trace.append({
                "name": sp.name, "cat": sp.category, "ph": "X",
                "ts": sp.start_s * 1e6,
                "dur": max(0.0, sp.end_s - sp.start_s) * 1e6,
                "pid": sp.pid, "tid": sp.tid, "args": sp.extra or {},
            })
        return trace
