"""Resource isolation for task workers: cgroup v2 with an rlimit tier
(a copy of ``ray_tpu/_private/cgroup.py``).

Two tiers, picked at runtime:
  * cgroup v2 — when the unified hierarchy is writable (root or delegated):
    ``<root>/ray_tpu_<pid>/workers`` gets ``memory.max``/``cpu.weight`` and
    worker pids are attached via ``cgroup.procs``.
  * rlimit — otherwise (unprivileged): workers apply ``RLIMIT_AS`` on
    themselves at boot from a spawn-env var.  Weaker (address space, not
    RSS; no cpu shares) but dependency-free and container-safe.

Both tiers are off unless ``enable_resource_isolation`` is set (matching
the reference's opt-in flag).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

from ._config import Config

WORKER_MEM_ENV = "RAY_TPU_WORKER_MEMORY_LIMIT"
CGROUP_ROOT = "/sys/fs/cgroup"


def _write(path: str, value: str) -> bool:
    try:
        with open(path, "w") as f:
            f.write(value)
        return True
    except OSError:
        return False


class CgroupManager:
    """Per-node worker cgroup (or rlimit-env fallback)."""

    def __init__(self, root: str = CGROUP_ROOT):
        self.enabled = bool(Config.get("enable_resource_isolation"))
        self.memory_limit = int(Config.get("worker_memory_limit_bytes"))
        self.cpu_weight = int(Config.get("worker_cgroup_cpu_weight"))
        self._root = root
        self._workers_dir: Optional[str] = None
        if not self.enabled:
            return
        self._workers_dir = self._try_setup_cgroup()

    @property
    def mode(self) -> str:
        if not self.enabled:
            return "off"
        return "cgroup" if self._workers_dir else "rlimit"

    def _try_setup_cgroup(self) -> Optional[str]:
        base = os.path.join(self._root, f"ray_tpu_{os.getpid()}")
        workers = os.path.join(base, "workers")
        try:
            os.makedirs(workers, exist_ok=True)
        except OSError:
            return None
        # Enable the controllers for the subtree; tolerate partial support.
        _write(os.path.join(base, "cgroup.subtree_control"), "+memory +cpu")
        ok = True
        if self.memory_limit > 0:
            ok = _write(os.path.join(workers, "memory.max"),
                        str(self.memory_limit)) and ok
        if self.cpu_weight > 0:
            _write(os.path.join(workers, "cpu.weight"),
                   str(self.cpu_weight))
        if not ok:
            # Partial delegation (dirs creatable, limits not writable):
            # remove what we created before falling back to rlimits, or
            # every node process strands a cgroup tree until reboot.
            for d in (workers, base):
                try:
                    os.rmdir(d)
                except OSError:
                    pass
            return None
        return workers

    # -- spawn-time hooks ----------------------------------------------------

    def spawn_env(self) -> Dict[str, str]:
        """Extra env for worker processes (rlimit tier applies it at
        worker boot — see worker_main)."""
        if self.enabled and self._workers_dir is None \
                and self.memory_limit > 0:
            return {WORKER_MEM_ENV: str(self.memory_limit)}
        return {}

    def add_process(self, pid: int) -> bool:
        """Attach a freshly spawned worker to the workers cgroup."""
        if self._workers_dir is None:
            return False
        return _write(os.path.join(self._workers_dir, "cgroup.procs"),
                      str(pid))

    def cleanup(self) -> None:
        if self._workers_dir is None:
            return
        base = os.path.dirname(self._workers_dir)
        for d in (self._workers_dir, base):
            try:
                os.rmdir(d)
            except OSError:
                pass


def apply_worker_rlimits() -> None:
    """Called by worker_main at boot: apply the rlimit tier's limits."""
    raw = os.environ.get(WORKER_MEM_ENV)
    if not raw:
        return
    try:
        import resource
        limit = int(raw)
        resource.setrlimit(resource.RLIMIT_AS, (limit, limit))
    except (ValueError, OSError, ImportError):
        pass
