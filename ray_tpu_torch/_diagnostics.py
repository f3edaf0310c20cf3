"""Live diagnostics: process stack capture and the debug bundle (a copy of
``ray_tpu/_private/diagnostics.py``).

* ``capture_process_stacks`` snapshots ``sys._current_frames()`` in the
  calling process and names the task each thread runs.  A node's worker
  runs it on its receive thread when the node asks, so a worker whose
  task thread is wedged in user code still answers; one that cannot
  answer at all (stopped, or stuck holding the GIL) is reported
  unresponsive by the head (``_runtime.Runtime.ctl_stack_dump``).
* ``write_debug_bundle`` collects stacks, the task-event tail, the last
  export events, a metrics snapshot and the goodput breakdown into one
  directory under ``<session>/debug/<timestamp>-<reason>/``.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

#: events.jsonl lines / task events captured into a bundle.
EVENT_TAIL_LINES = 200
TASK_EVENT_TAIL = 500
SCHED_DECISION_TAIL = 500


def capture_process_stacks(worker_id: str,
                           actor_id: Optional[str] = None,
                           thread_tasks: Optional[Dict[int, tuple]] = None,
                           is_driver: bool = False) -> Dict[str, Any]:
    """Snapshot every thread's Python stack in THIS process.

    ``thread_tasks`` maps thread idents to ``(task_id_hex, task_name)``
    for threads currently executing a task (maintained by the worker's
    ``_run_task_inner``), so the dump names what each thread is running,
    not just where it is.
    """
    names: Dict[int, tuple] = {}
    for t in threading.enumerate():
        if t.ident is not None:
            names[t.ident] = (t.name, t.daemon)
    threads: List[Dict[str, Any]] = []
    for tid, frame in sys._current_frames().items():
        name, daemon = names.get(tid, ("<unknown>", True))
        task_id, task_name = (thread_tasks or {}).get(tid, (None, None))
        frames = [ln.rstrip("\n")
                  for ln in traceback.format_stack(frame)]
        threads.append({
            "thread_id": tid, "name": name, "daemon": daemon,
            "task_id": task_id, "task_name": task_name,
            "frames": frames,
        })
    threads.sort(key=lambda t: (t["daemon"], t["name"]))
    return {
        "worker_id": worker_id,
        "pid": os.getpid(),
        "is_driver": is_driver,
        "actor_id": actor_id,
        "time": time.time(),
        "threads": threads,
    }


def format_stack_dump(dump: Dict[str, Any]) -> str:
    """Human-readable rendering of a ``ctl_stack_dump`` result (the
    ``ray-tpu stack`` CLI output)."""
    lines: List[str] = [f"=== cluster stack dump @ {dump.get('time')} ==="]
    for rec in dump.get("stacks", ()):
        who = "driver" if rec.get("is_driver") else f"worker {rec['worker_id'][:12]}"
        head = f"--- {who} pid={rec.get('pid')}"
        if rec.get("actor_id"):
            head += f" actor={rec['actor_id'][:12]}"
        if rec.get("node_id"):
            head += f" node={rec['node_id'][:12]}"
        lines.append(head + " ---")
        for th in rec.get("threads", ()):
            tag = f"thread {th['name']} (id={th['thread_id']})"
            if th.get("task_name"):
                tag += f" running task {th['task_name']} [{th['task_id']}]"
            lines.append(tag)
            lines.extend("  " + f for f in th.get("frames", ()))
    missing = dump.get("unresponsive") or ()
    if missing:
        lines.append(f"unresponsive workers (no reply in time): "
                     f"{', '.join(w[:12] for w in missing)}")
    return "\n".join(lines)


def _slug(reason: str, maxlen: int = 48) -> str:
    out = "".join(c if c.isalnum() or c in "-_" else "_" for c in reason)
    return out[:maxlen] or "dump"


def write_debug_bundle(rt, reason: str,
                       stacks: Optional[Dict[str, Any]] = None,
                       capture_stacks: bool = True,
                       stack_timeout_s: float = 2.0,
                       extra: Optional[Dict[str, Any]] = None) -> str:
    """Write a postmortem bundle for the head's runtime (``_runtime``);
    returns the bundle directory path.  Every section is best-effort: a
    broken subsystem must never stop the remaining forensics from
    landing.  (JAX's bundle also attaches a cluster profile and the
    metrics history: the port's head has neither yet, ROADMAP Queue 1
    item 14.)"""
    ts = time.strftime("%Y%m%d-%H%M%S")
    frac = int((time.time() % 1) * 1e6)
    path = os.path.join(rt.session_dir, "debug",
                        f"{ts}-{frac:06d}-{_slug(reason)}")
    os.makedirs(path, exist_ok=True)
    contents: List[str] = []

    def section(fname: str, produce) -> None:
        from . import _sanitizer as sanitizer
        try:
            data = produce()
            if data is None:
                return
            # tracked_open: bundle handles register with the leak
            # sanitizer while open, so a wedged producer shows up in the
            # shutdown diff with this site.
            with sanitizer.tracked_open(os.path.join(path, fname),
                                        "w") as f:
                f.write(data)
            contents.append(fname)
        except Exception:  # noqa: BLE001 — forensics are best-effort
            pass

    if stacks is None and capture_stacks:
        try:
            stacks = rt.ctl_stack_dump(timeout_s=stack_timeout_s)
        except Exception:  # noqa: BLE001
            stacks = None
    if stacks is not None:
        section("stacks.json",
                lambda: json.dumps(stacks, indent=1, default=str))
    section("task_events.json", lambda: json.dumps(
        rt.events.snapshot(limit=TASK_EVENT_TAIL), indent=1, default=str))
    section("events_tail.jsonl", lambda: "\n".join(
        rt.log_monitor.tail("events.jsonl", EVENT_TAIL_LINES)) + "\n")

    def _metrics():
        from ray_tpu_torch.util.metrics import prometheus_text
        return prometheus_text()
    section("metrics.prom", _metrics)

    def _goodput():
        from ray_tpu_torch.util.telemetry import goodput_summary
        g = goodput_summary()
        return json.dumps(g, indent=1) if g is not None else None
    section("goodput.json", _goodput)

    def _sched():
        # Scheduler decision ring + queue depths: a hang bundle should
        # say WHY the pending tasks are pending, not just that they are.
        sched = getattr(rt, "scheduler", None)
        if sched is None or not hasattr(sched, "ring"):
            return None
        return json.dumps({
            "stats": sched.ring.stats(),
            "queues": sched.queue_depths(),
            "decisions": sched.ring.snapshot(limit=SCHED_DECISION_TAIL),
        }, indent=1, default=str)
    section("sched_decisions.json", _sched)

    def _locks():
        # Lock-order detector findings (RAY_TPU_DEBUG_LOCKS=1): written
        # whenever the detector is active or has recorded anything, so a
        # deadlock bundle carries the acquisition-order story.
        from ray_tpu_torch.devtools import lockdebug
        rep = lockdebug.report()
        if not rep["installed"] and not rep["findings"]:
            return None
        return json.dumps(rep, indent=1, default=str)
    section("lock_findings.json", _locks)

    def _lock_contention():
        # Contention profiler snapshot (RAY_TPU_LOCK_PROFILE=1 or
        # RAY_TPU_DEBUG_LOCKS=1): per-site wait/hold histograms, so a
        # slow-control-plane bundle names its hottest lock.  Render
        # with `ray-tpu lint --lock-report <file>`.
        from ray_tpu_torch.devtools import lockdebug
        rep = lockdebug.contention_report()
        if not rep["installed"] and not rep["sites"]:
            return None
        return json.dumps(rep, indent=1, default=str)
    section("lock_contention.json", _lock_contention)

    def _syncs():
        # Host-sync tripwire snapshot (RAY_TPU_SYNC_DEBUG=1): per-site
        # implicit device->host sync counts and blocked-time histograms,
        # so a slow-step bundle names the line stalling on the device.
        # Render with `ray-tpu lint --sync-report <file>`.
        from ray_tpu_torch.devtools import syncdebug
        rep = syncdebug.report()
        if not rep["installed"] and not rep["sites"]:
            return None
        return json.dumps(rep, indent=1, default=str)
    section("sync_findings.json", _syncs)

    def _leaks():
        # Leak-sanitizer registries (RAY_TPU_SANITIZE=1): the live
        # framework threads / pins / tracked handles / named actors with
        # creation sites — a hang/death bundle shows what was held.
        from ray_tpu_torch import _sanitizer as sanitizer
        if not sanitizer.is_enabled():
            return None
        return json.dumps(sanitizer.report(), indent=1, default=str)
    section("leak_findings.json", _leaks)

    section("manifest.json", lambda: json.dumps({
        "reason": reason,
        "time": time.time(),
        "session_dir": rt.session_dir,
        "extra": extra or {},
        "contents": sorted(contents),
    }, indent=1, default=str))
    return path
