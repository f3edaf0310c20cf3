"""Hang/straggler watchdog over the train report stream (a copy of
ray_tpu/train/watchdog.py over the port's control plane).

Reference analogs: the dashboard's hang detection over the GCS task-event
history plus MegaScale-style straggler detection — at pod scale one
silently slow host destroys the goodput ratio the telemetry layer
measures, so slowness must be *flagged*, not just averaged away.

The watchdog runs a driver-side monitor thread fed by the per-rank
``train.report()`` stream the controller already polls:

* **straggler** — a rank's completed report-to-report interval exceeds
  ``straggler_multiple`` × the across-rank median interval.
* **hang** — a rank that has reported at least once produces no further
  report within ``hang_deadline_s`` (detection starts after the first
  report so init/compile windows can't trip it).

On a verdict it bumps the ``ray_tpu_train_straggler_total`` /
``ray_tpu_train_hang_total`` counters, exports a structured
``EXPORT_TRAIN_WATCHDOG`` event on the control plane, publishes the
verdict under ``VERDICT_KV_KEY``, and writes a verdict bundle file through
the ``dump`` callable the controller passes (with every worker's stacks,
which each worker's ``faulthandler`` writes on ``SIGUSR1``, and with
``bundle_profile_s`` > 0 a profile of that length of the driver and every
live worker, merged into one trace beside it).  Verdicts are
once-per-incident: a rank re-arms when it recovers.
"""

from __future__ import annotations

import json
import statistics
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

#: Control-plane key of the last verdict (JAX's ``ray-tpu status`` reads
#: it).
VERDICT_KV_KEY = "diagnostics/watchdog/last_verdict"


@dataclass
class WatchdogConfig:
    """Knobs for the train hang/straggler watchdog (RunConfig.watchdog)."""
    enabled: bool = True
    # A rank whose completed step interval exceeds this multiple of the
    # across-rank median is a straggler.
    straggler_multiple: float = 3.0
    # A rank that reported once but stays silent this long is hung.
    hang_deadline_s: float = 120.0
    # Monitor thread poll period (hang checks + verdict refresh).
    poll_interval_s: float = 1.0
    # Completed intervals a rank needs before straggler checks apply.
    min_samples: int = 2
    # Capture a cluster stack snapshot into the verdict bundle.
    capture_stacks: bool = True
    # Write a flight-recorder bundle on each verdict.
    write_bundle: bool = True
    # On-demand profile of this duration in the trip bundle (0: none).
    bundle_profile_s: float = 0.0


class _RankState:
    __slots__ = ("last_stamp", "last_mono", "intervals", "pid",
                 "hung", "straggling", "done", "incarnation",
                 "drain_until_mono")

    def __init__(self):
        # Verdict suppression window: while a rank's node drains (planned
        # preemption), silence and slow steps are EXPECTED — the urgent
        # checkpoint flush stalls the step loop by design, and a "hang"
        # verdict (plus its auto-captured bundle) would cry wolf.
        self.drain_until_mono: float = 0.0
        # Worker-side stamp for interval math: the worker's monotonic
        # clock when available (same-process deltas are NTP-immune),
        # its wall clock as a fallback for old payloads.
        self.last_stamp: Optional[float] = None
        self.last_mono: Optional[float] = None   # driver-side receipt time
        self.intervals: deque = deque(maxlen=16)
        self.pid: Optional[int] = None
        self.hung = False
        self.straggling = False
        self.done = False
        # Worker incarnation the stamps belong to: monotonic clocks are
        # only comparable within one process, so a stamp from a new
        # incarnation (restart — possibly on another host) must never be
        # differenced against the old one.
        self.incarnation: Optional[str] = None


class TrainWatchdog:
    """Driver-side monitor; the controller feeds it report payloads."""

    def __init__(self, run_id: str, config: Optional[WatchdogConfig] = None,
                 dump: Optional[Callable[..., Optional[str]]] = None):
        self.run_id = run_id
        self.config = config or WatchdogConfig()
        #: dump(name, extra, capture_stacks, profile_s) -> bundle path
        #: (the controller's; None: no bundles).
        self._dump = dump
        self._lock = threading.Lock()
        self._ranks: Dict[int, _RankState] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._bundle_threads: list = []
        self.straggler_count = 0
        self.hang_count = 0
        self.last_verdict: Dict[str, Any] = {
            "status": "ok", "run_id": run_id, "time": time.time(),
            "straggler_total": 0, "hang_total": 0}

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if not self.config.enabled or self._thread is not None:
            return
        self._publish_verdict()
        self._thread = threading.Thread(target=self._poll_loop,
                                        name="train-watchdog", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        self._thread = None
        # Verdict bundles write on background threads (a 2s stack capture
        # must not stall the controller's report-polling loop); joining
        # here makes the forensics durable before fit() returns.
        with self._lock:
            pending, self._bundle_threads = self._bundle_threads, []
        for bt in pending:
            bt.join(timeout=10.0)

    def reset_ranks(self) -> None:
        """A new worker group is forming (restart/resize): old rank
        clocks are meaningless against the fresh incarnation."""
        with self._lock:
            self._ranks.clear()

    # -- controller feed ---------------------------------------------------

    def note_report(self, rank: int, report_time: float,
                    pid: Optional[int] = None,
                    report_mono: Optional[float] = None,
                    incarnation: Optional[str] = None) -> None:
        if not self.config.enabled:
            return
        now = time.monotonic()
        stamp = report_mono if report_mono is not None else report_time
        recovered = False
        with self._lock:
            st = self._ranks.setdefault(rank, _RankState())
            if incarnation != st.incarnation:
                # New worker incarnation (or a stale pre-restart report
                # replayed from the KV after reset_ranks): its clock has
                # a different base — drop the interval baseline instead
                # of producing a cross-process garbage delta.
                st.last_stamp = None
                st.intervals.clear()
                st.incarnation = incarnation
            if st.last_stamp is not None:
                st.intervals.append(max(0.0, stamp - st.last_stamp))
            st.last_stamp = stamp
            st.last_mono = now
            st.pid = pid
            if st.hung:
                st.hung = False
                recovered = True
            # Counter snapshot under the lock (RT401): _check_straggler
            # and _poll_loop bump these under it concurrently.
            straggler_total = self.straggler_count
            hang_total = self.hang_count
        if recovered:
            # Refresh the KV verdict too: `ray-tpu status` must stop
            # saying "hang" once the rank is demonstrably reporting.
            self.last_verdict = {
                "status": "recovered", "run_id": self.run_id,
                "rank": rank, "pid": pid, "time": time.time(),
                "straggler_total": straggler_total,
                "hang_total": hang_total}
            self._export("recovered", rank, {"detail": "report resumed"})
            self._publish_verdict()
        self._check_straggler(rank)

    def note_done(self, rank: int) -> None:
        """Rank finished its train fn: silence is now legitimate."""
        with self._lock:
            st = self._ranks.get(rank)
            if st is not None:
                st.done = True

    def note_drain(self, ranks, window_s: float) -> None:
        """Ranks sit on a draining node: suppress hang/straggler verdicts
        for them during the drain window.  A planned drain stalls the
        step loop (urgent checkpoint flush, teardown wait) — that must
        not trip a "hang" verdict or auto-capture a bundle."""
        until = time.monotonic() + max(0.0, window_s)
        with self._lock:
            for rank in ranks:
                st = self._ranks.setdefault(rank, _RankState())
                st.drain_until_mono = max(st.drain_until_mono, until)

    # -- detection ---------------------------------------------------------

    def _median_interval_locked(self,
                                exclude_rank: Optional[int] = None
                                ) -> Optional[float]:
        # Leave-one-out: the candidate's own slow steps must not drag the
        # baseline up (with 2 ranks a 6x straggler would otherwise pull
        # the median past its own threshold and never be flagged).
        per_rank = [statistics.median(st.intervals)
                    for r, st in self._ranks.items()
                    if r != exclude_rank and len(st.intervals) >= 1]
        if not per_rank:
            return None  # a single reporting rank has no peer baseline
        return statistics.median(per_rank)

    def _check_straggler(self, rank: int) -> None:
        cfg = self.config
        with self._lock:
            st = self._ranks.get(rank)
            if st is None or st.done or \
                    time.monotonic() < st.drain_until_mono or \
                    len(st.intervals) < max(1, cfg.min_samples):
                return
            median = self._median_interval_locked(exclude_rank=rank)
            last = st.intervals[-1]
            if median is None or median <= 0:
                return
            threshold = cfg.straggler_multiple * median
            if last <= threshold:
                st.straggling = False  # recovered: re-arm
                return
            if st.straggling:
                return  # already flagged this incident
            st.straggling = True
            self.straggler_count += 1
        self._trip("straggler", rank, {
            "step_seconds": last, "median_step_seconds": median,
            "straggler_multiple": cfg.straggler_multiple,
            "threshold_seconds": threshold})

    def _poll_loop(self) -> None:
        cfg = self.config
        while not self._stop.wait(cfg.poll_interval_s):
            now = time.monotonic()
            tripped = []
            with self._lock:
                for rank, st in self._ranks.items():
                    if st.done or st.hung or st.last_mono is None or \
                            now < st.drain_until_mono:
                        continue
                    silent = now - st.last_mono
                    if silent > cfg.hang_deadline_s:
                        st.hung = True
                        self.hang_count += 1
                        tripped.append((rank, silent))
            for rank, silent in tripped:
                self._trip("hang", rank, {
                    "silent_seconds": silent,
                    "hang_deadline_s": cfg.hang_deadline_s})

    # -- verdict fan-out ---------------------------------------------------

    def _trip(self, kind: str, rank: int, detail: Dict[str, Any]) -> None:
        from ..util import telemetry
        telemetry.inc(f"ray_tpu_train_{kind}_total")
        with self._lock:
            pid = self._ranks.get(rank).pid if rank in self._ranks else None
            # Counter snapshot under the lock (RT401): the poll loop
            # bumps these under it concurrently.
            straggler_total = self.straggler_count
            hang_total = self.hang_count
        self.last_verdict = {
            "status": kind, "run_id": self.run_id, "rank": rank,
            "pid": pid, "time": time.time(), "detail": detail,
            "straggler_total": straggler_total,
            "hang_total": hang_total}
        self._export(kind, rank, dict(detail, pid=pid))
        self._publish_verdict()
        if self.config.write_bundle and self._dump is not None:
            # Off-thread: the bundle's stack capture can take seconds and
            # _trip may run on the controller's report-polling loop.
            verdict = dict(self.last_verdict)

            def _write():
                try:
                    self._dump(f"watchdog_{kind}_rank{rank}",
                               {"verdict": verdict},
                               self.config.capture_stacks,
                               self.config.bundle_profile_s or None)
                except Exception as e:  # noqa: BLE001 — best-effort
                    from ..util import telemetry
                    telemetry.note_swallowed("train.watchdog.bundle", e)
            bt = threading.Thread(target=_write, name="watchdog-bundle",
                                  daemon=True)
            with self._lock:
                self._bundle_threads.append(bt)
            bt.start()

    def _export(self, kind: str, rank: int, detail: Dict[str, Any]) -> None:
        try:
            from .._control import _control
            _control("export_event", "EXPORT_TRAIN_WATCHDOG", {
                "kind": kind, "rank": rank, "run_id": self.run_id,
                **detail})
        except Exception:  # noqa: BLE001
            pass

    def _publish_verdict(self) -> None:
        try:
            from .._control import _control
            _control("kv_put", VERDICT_KV_KEY,
                     json.dumps(self.last_verdict).encode())
        except Exception:  # noqa: BLE001
            pass
