"""Host memory monitor + OOM worker-killing policy (a copy of
``ray_tpu/_private/memory_monitor.py``; ``_tasks`` runs it in the driver
over the session's task workers).

The monitor samples node memory (cgroup-v2 limits when the process is
inside a bounded cgroup, /proc/meminfo otherwise), and when usage crosses
the configured threshold it asks the kill policy for a victim worker and
SIGKILLs it.  The runtime's existing worker-death path then retries the
killed task (if retriable) or fails it with an OOM-flavored error.

Victim selection mirrors the reference's retriable-LIFO policy
(worker_killing_policy_retriable_fifo.h): prefer workers whose running
tasks can be retried, and among those kill the most recently started —
protecting long-running work and never starving the node of progress
(the earliest-started non-retriable worker is killed only as last resort).
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

from ._config import Config

_CGROUP_MAX = "/sys/fs/cgroup/memory.max"
_CGROUP_CUR = "/sys/fs/cgroup/memory.current"


@dataclass
class MemorySnapshot:
    used_bytes: int
    total_bytes: int

    @property
    def fraction(self) -> float:
        return self.used_bytes / self.total_bytes if self.total_bytes else 0.0


def _read_int(path: str) -> Optional[int]:
    try:
        with open(path) as f:
            raw = f.read().strip()
        return None if raw == "max" else int(raw)
    except (OSError, ValueError):
        return None


def system_memory() -> MemorySnapshot:
    """Node memory usage: bounded cgroup v2 if present, else /proc/meminfo."""
    limit = _read_int(_CGROUP_MAX)
    current = _read_int(_CGROUP_CUR)
    if limit is not None and current is not None:
        return MemorySnapshot(current, limit)
    total = avail = 0
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    total = int(line.split()[1]) * 1024
                elif line.startswith("MemAvailable:"):
                    avail = int(line.split()[1]) * 1024
    except OSError:
        pass
    return MemorySnapshot(max(total - avail, 0), total)


def process_rss(pid: int) -> int:
    try:
        with open(f"/proc/{pid}/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return 0


def select_victim(candidates: List[Tuple[object, bool, float]]) -> Optional[object]:
    """Pick the worker to kill from (handle, retriable, earliest_start) rows.

    Retriable-last-started first; non-retriable workers only when no
    retriable candidate exists, and then also last-started (the reference
    kills LIFO within each group so the oldest work survives).
    """
    if not candidates:
        return None
    retriable = [c for c in candidates if c[1]]
    group = retriable if retriable else candidates
    return max(group, key=lambda c: c[2])[0]


class MemoryMonitor:
    """Polls memory usage and OOM-kills workers above the threshold.

    ``usage_fn`` is injectable for tests; the ``memory_monitor_test_fraction``
    config flag overrides the observed usage fraction so integration tests can
    trip the killer deterministically from another process.
    """

    def __init__(self, node_manager,
                 usage_fn: Callable[[], MemorySnapshot] = system_memory):
        self._node = node_manager
        self._usage_fn = usage_fn
        self._threshold = Config.get("memory_usage_threshold")
        self._period_s = Config.get("memory_monitor_refresh_ms") / 1000.0
        self._min_interval_s = Config.get("memory_monitor_kill_interval_s")
        self._last_kill = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._period_s <= 0 or self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop,
                                        name="memory-monitor", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        # Joined (bounded): a session's shutdown leaves no monitor thread
        # for the leak sanitizer's diff.
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)

    def _loop(self) -> None:
        while not self._stop.wait(self._period_s):
            try:
                self.check_once()
            except Exception:  # noqa: BLE001 — monitor must never die
                pass

    def snapshot(self) -> MemorySnapshot:
        fake = Config.get("memory_monitor_test_fraction")
        if fake > 0:
            return MemorySnapshot(int(fake * 1e9), int(1e9))
        return self._usage_fn()

    def check_once(self) -> Optional[object]:
        """One poll; returns the killed worker handle (or None)."""
        snap = self.snapshot()
        if snap.fraction < self._threshold:
            return None
        now = time.monotonic()
        if now - self._last_kill < self._min_interval_s:
            return None
        victim = self._node.select_oom_victim()
        if victim is None:
            return None
        self._last_kill = now
        self._node.oom_kill_worker(
            victim,
            f"node memory usage {snap.fraction:.0%} "
            f"({snap.used_bytes >> 20} MiB / {snap.total_bytes >> 20} MiB) "
            f"over threshold {self._threshold:.0%}")
        return victim
