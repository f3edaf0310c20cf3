"""SLO-driven decode-replica autoscaling for the serving fleet (a copy of
ray_tpu/llm/fleet/autoscale.py).

Windowed observations in a private ``metricsview.SeriesStore``, sustain +
cooldown + max-pending spend bounds.  The observed signals are the
admission router's **queue depth**, **shed rate**, and **inter-token
latency p99** — the three SLO burn axes of a decode fleet — and the
actuator is a replica count instead of a node buy.

Pure decision logic: the caller (``FleetServer``'s manager loop) feeds
``observe()`` once per tick and executes whatever ``decide()`` returns.
Scale-ups are bounded by ``cooldown_s`` and a single pending add (a
replica still compiling must not trigger another); scale-downs require
EVERY signal idle for ``down_sustain_s`` and always go through drain —
the policy only ever names a direction, never kills work.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ...metricsview import SeriesStore

_QUEUE = "serve_fleet_queue_depth"
_SHED = "serve_fleet_shed_total"
_DONE = "serve_fleet_completed_total"
_ITL = "serve_fleet_itl_seconds"

#: Finite ITL histogram boundaries (seconds): serving ITL lives in the
#: 1 ms..1 s band; the +Inf bucket is implicit in the counts vector.
_ITL_BOUNDS = [0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
               0.25, 0.5, 1.0]


@dataclass
class ServeScaleConfig:
    min_replicas: int = 1
    max_replicas: int = 4
    #: Windowed mean router queue depth PER REPLICA above this is burn.
    queue_high: float = 2.0
    #: Windowed shed fraction (sheds / offered) above this is burn.
    shed_rate_high: float = 0.05
    #: Windowed ITL p99 above this is burn (None disables the axis).
    itl_p99_high_ms: Optional[float] = None
    #: Burn must persist this long before an upscale fires.
    sustain_s: float = 1.5
    #: Every signal must be idle this long before a downscale fires
    #: (longer than sustain_s: adding capacity is cheap to undo, losing
    #: a warm replica under returning load is not).
    down_sustain_s: float = 6.0
    #: Minimum spacing between EXECUTED scale actions.
    cooldown_s: float = 5.0
    #: Observation window for the queue/shed/ITL queries.
    window_s: float = 5.0
    #: Idle thresholds for the downscale path.
    queue_low: float = 0.25


@dataclass
class FleetScaleDecision:
    direction: str           # "up" | "down"
    reason: str              # the burning (or idle) axis
    #: Windowed signal snapshot at decision time (status surface).
    signals: Dict[str, Any] = field(default_factory=dict)


class ServeAutoscalePolicy:
    """(queue depth, shed rate, ITL p99) -> replica-count decisions."""

    def __init__(self, config: Optional[ServeScaleConfig] = None):
        self.config = config or ServeScaleConfig()
        self._window = SeriesStore(
            interval_s=0.25,
            max_points=max(64, int(self.config.window_s * 16)),
            max_series=8)
        self._itl_counts = [0] * (len(_ITL_BOUNDS) + 1)
        self._itl_sum = 0.0
        self._itl_n = 0
        self._burn_since: Optional[float] = None
        self._idle_since: Optional[float] = None
        self._last_action = -1e18
        self._last_observed: Optional[float] = None
        self._replicas = 1
        #: Latest windowed signals (status/introspection).
        self.last_signals: Dict[str, Any] = {}

    # -- observations ------------------------------------------------------

    def observe(self, queue_depth: int, shed_total: int,
                completed_total: int, replicas: int,
                itl_samples: Optional[List[float]] = None,
                now: Optional[float] = None) -> None:
        """One manager tick: live queue depth, cumulative shed/completed
        counters, current replica count, and any new per-token latency
        samples since the last tick."""
        now = time.monotonic() if now is None else now
        self._replicas = max(1, int(replicas))
        self._window.append(_QUEUE, {}, "gauge", float(queue_depth), now)
        self._window.append(_SHED, {}, "counter", float(shed_total), now)
        self._window.append(_DONE, {}, "counter", float(completed_total),
                            now)
        for s in itl_samples or ():
            i = 0
            while i < len(_ITL_BOUNDS) and s > _ITL_BOUNDS[i]:
                i += 1
            for j in range(i, len(self._itl_counts)):
                self._itl_counts[j] += 1
            self._itl_sum += s
            self._itl_n += 1
        self._window.append(
            _ITL, {}, "histogram",
            {"counts": list(self._itl_counts), "sum": self._itl_sum,
             "count": self._itl_n}, now, bounds=_ITL_BOUNDS)
        self._last_observed = now

    def _signals(self, now: float) -> Dict[str, Any]:
        w = self.config.window_s
        q = self._window.query(_QUEUE, w, "avg", now=now)["value"]
        d_shed = self._window.query(_SHED, w, "delta", now=now)["value"]
        d_done = self._window.query(_DONE, w, "delta", now=now)["value"]
        p99 = self._window.query(_ITL, w, "p99", now=now)["value"]
        offered = (d_shed or 0.0) + (d_done or 0.0)
        return {
            "queue_depth": q,
            "queue_per_replica": (q / self._replicas)
            if q is not None else None,
            "shed_rate": ((d_shed or 0.0) / offered) if offered else 0.0,
            "sheds": d_shed, "completed": d_done,
            "itl_p99_ms": p99 * 1000.0 if p99 is not None else None,
        }

    # -- decisions ---------------------------------------------------------

    def decide(self, pending: int = 0, now: Optional[float] = None
               ) -> Optional[FleetScaleDecision]:
        """One tick's decision; ``pending`` counts scale actions still
        executing (a booting replica, a draining one)."""
        now = time.monotonic() if now is None else now
        cfg = self.config
        if self._last_observed is None:
            return None
        sig = self._signals(self._last_observed)
        self.last_signals = sig

        burn_reason = None
        if sig["queue_per_replica"] is not None \
                and sig["queue_per_replica"] > cfg.queue_high:
            burn_reason = "queue_depth"
        elif sig["shed_rate"] > cfg.shed_rate_high:
            burn_reason = "shed_rate"
        elif cfg.itl_p99_high_ms is not None \
                and sig["itl_p99_ms"] is not None \
                and sig["itl_p99_ms"] > cfg.itl_p99_high_ms:
            burn_reason = "itl_p99"

        idle = (sig["queue_per_replica"] is not None
                and sig["queue_per_replica"] <= cfg.queue_low
                and sig["shed_rate"] <= 0.0
                and (cfg.itl_p99_high_ms is None
                     or sig["itl_p99_ms"] is None
                     or sig["itl_p99_ms"] <= cfg.itl_p99_high_ms))

        if burn_reason is not None:
            self._idle_since = None
            if self._burn_since is None:
                self._burn_since = now
            if self._replicas + pending < cfg.max_replicas \
                    and pending < 1 \
                    and now - self._burn_since >= cfg.sustain_s \
                    and now - self._last_action >= cfg.cooldown_s:
                self._last_action = now
                return FleetScaleDecision("up", burn_reason, sig)
            return None
        self._burn_since = None

        if idle:
            if self._idle_since is None:
                self._idle_since = now
            if self._replicas > cfg.min_replicas and pending < 1 \
                    and now - self._idle_since >= cfg.down_sustain_s \
                    and now - self._last_action >= cfg.cooldown_s:
                self._last_action = now
                return FleetScaleDecision("down", "idle", sig)
        else:
            self._idle_since = None
        return None

    def forget_action(self) -> None:
        """The caller could not execute the returned decision (replica
        spawn failed, nothing drainable): un-stamp the cooldown so the
        next eligible tick retries instead of burning the budget."""
        self._last_action = -1e18

    # -- introspection -----------------------------------------------------

    def status(self, now: Optional[float] = None) -> Dict[str, Any]:
        now = time.monotonic() if now is None else now
        cooldown_left = max(
            0.0, self.config.cooldown_s - (now - self._last_action)) \
            if self._last_action > -1e17 else 0.0
        return {
            "signals": dict(self.last_signals),
            "burning_for_s": (now - self._burn_since)
            if self._burn_since is not None else None,
            "idle_for_s": (now - self._idle_since)
            if self._idle_since is not None else None,
            "cooldown_remaining_s": cooldown_left,
            "min_replicas": self.config.min_replicas,
            "max_replicas": self.config.max_replicas,
        }
