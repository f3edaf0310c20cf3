"""The typed flags the scheduler tier and the head read (a copy of the part
of ``ray_tpu/_private/config.py`` that ``_scheduler``, ``_cgroup``,
``_memory_monitor``, ``_actor``, ``_persist`` and ``_cluster`` call, with
the same names, defaults and precedence):

    ``Config.initialize(overrides)``  >  env ``RAY_TPU_<NAME>``  >  default.
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

ENV_PREFIX = "RAY_TPU_"


def _parse_bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")


_PARSERS: Dict[type, Callable[[str], Any]] = {
    bool: _parse_bool,
    int: lambda s: int(s, 0),
    float: float,
    str: str,
}


@dataclass
class _Flag:
    name: str
    type: type
    default: Any
    doc: str


class Config:
    """Process-wide typed flag registry with env overrides."""

    _flags: Dict[str, _Flag] = {}
    _values: Dict[str, Any] = {}
    _lock = threading.Lock()
    _initialized = False

    @classmethod
    def define(cls, name: str, type_: type, default: Any,
               doc: str = "") -> None:
        cls._flags[name] = _Flag(name, type_, default, doc)

    @classmethod
    def initialize(cls, overrides: Optional[Dict[str, Any]] = None) -> None:
        """Resolve all flags (idempotent refresh allowed)."""
        with cls._lock:
            values: Dict[str, Any] = {}
            for name, flag in cls._flags.items():
                val = flag.default
                env_val = os.environ.get(ENV_PREFIX + name.upper())
                if env_val is not None:
                    val = _PARSERS[flag.type](env_val)
                if overrides and name in overrides:
                    val = overrides[name]
                if val is not None and not isinstance(val, flag.type):
                    val = flag.type(val)
                values[name] = val
            cls._values = values
            cls._initialized = True

    @classmethod
    def get(cls, name: str) -> Any:
        if not cls._initialized:
            cls.initialize()
        try:
            return cls._values[name]
        except KeyError:
            raise KeyError(f"unknown config flag: {name}") from None

    @classmethod
    def blob(cls) -> str:
        """JSON of the resolved flags (the head hands it to a client,
        which ``initialize``s from it)."""
        if not cls._initialized:
            cls.initialize()
        return json.dumps(cls._values)

    @classmethod
    def set(cls, name: str, value: Any) -> None:
        if not cls._initialized:
            cls.initialize()
        if name not in cls._flags:
            raise KeyError(f"unknown config flag: {name}")
        with cls._lock:
            cls._values[name] = value


D = Config.define

# --- Scheduler -------------------------------------------------------------
D("scheduler_spread_threshold", float, 0.5,
  "Hybrid policy: pack onto nodes under this utilization, then spread.")
D("sched_decision_ring_size", int, 4096,
  "Bounded scheduler decision-ring capacity (schedview).")

# --- Resource isolation ----------------------------------------------------
D("enable_resource_isolation", bool, False,
  "Isolate worker processes (cgroup v2 when writable, RLIMIT_AS "
  "otherwise).")
D("worker_memory_limit_bytes", int, 0,
  "Per-worker-tree memory cap (cgroup memory.max / worker RLIMIT_AS); "
  "0 = unlimited.")
D("worker_cgroup_cpu_weight", int, 0,
  "cpu.weight for the workers cgroup (cgroup tier only); 0 = default.")

# --- Memory monitor / OOM killing ------------------------------------------
D("memory_monitor_refresh_ms", int, 0,
  "Memory monitor poll period; 0 disables.")
D("memory_usage_threshold", float, 0.95,
  "Host memory usage fraction above which a worker is OOM-killed.")
D("memory_monitor_kill_interval_s", float, 2.0,
  "Minimum time between successive OOM kills.")
D("memory_monitor_test_fraction", float, 0.0,
  "Testing hook: fake observed memory usage fraction (>0 overrides real "
  "sampling so OOM paths are deterministically testable).")

# --- Actors and the head ---------------------------------------------------
D("actor_max_restarts_default", int, 0, "Default actor restarts.")
D("head_wal_fsync", bool, False,
  "fsync each head-state WAL append.  Off by default: flush-per-append "
  "already survives head-process death (the protected failure mode); "
  "fsync buys machine-crash durability at write-latency cost.")
D("max_inline_object_size", int, 100 * 1024,
  "Objects <= this many bytes travel inline in control messages; a "
  "client's larger put goes to the head's shared-memory store.")
D("health_check_period_s", float, 1.0,
  "Head -> client liveness probe period.")
D("health_check_failure_threshold", int, 5,
  "Missed probe periods before the head closes a silent client.")

# --- Nodes (the node plane) ------------------------------------------------
D("object_store_memory", int, 2 * 1024 ** 3,
  "Soft cap on bytes a node's shared-memory store holds before it spills "
  "the least recently used objects.")
D("object_spill_dir", str, "",
  "Directory a node's store spills to (empty = <session_dir>/spill).")
D("node_reconnect_grace_s", float, 5.0,
  "After a node's control connection drops, how long the head waits for "
  "it to re-attach (same identity, tasks and actors kept) before it runs "
  "the node-death fan-out; a node on the head's host whose process is "
  "gone is dead at once.")

# --- Logging ---------------------------------------------------------------
D("session_dir", str, "",
  "Session directory (empty = <tmp>/ray_tpu_torch/session_*).")
