"""Profiling of the port (counterpart of ray_tpu/profiler).

Three pieces:

* **On-demand capture** — :func:`profile`: the driver and every live actor
  of the session (``_actor``'s processes) sample their Python threads and,
  with ``torch_profile``, bracket the window with ``torch.profiler`` for
  N seconds; the driver merges the records into one clock-aligned
  Chrome-trace JSON under a ``profiles/`` directory.
* **Step attribution** — :class:`step_phase` / :func:`fence`.
* **Recompile detection** — :func:`track` / :func:`install_recompile_
  detector`: per-site counts of kernel builds and first launches of a new
  launch shape, and a once-per-site warning when a warm site meets a new
  one, naming the argument shapes that churned (``recompile.py``).
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Any, Dict, Optional

from .attribution import fence, step_phase
from .recompile import install as install_recompile_detector
from .recompile import track, uninstall as uninstall_recompile_detector

#: Seconds past the window that a process's capture may take to come back
#: before it counts as unresponsive (JAX: ``stack_dump_timeout_s``).
COLLECT_TIMEOUT_S = 10.0
#: With ``torch_profile``, seconds more for the profiler's start: a
#: process's first window opens only once CUPTI is set up (8.8-10.8 s in
#: a llama_1b replica serving on an H100 80GB HBM3 at 700 W).
TORCH_START_S = 15.0
#: With ``torch_profile``, seconds more for each second of the window: a
#: process stops the profiler, exports its trace and reads it back before
#: it answers, and that work grows with the events of the window (3.0 s
#: for each second in that replica, ~30k kernels a second).
TORCH_EXPORT_S_PER_S = 5.0


def _capture_in_actor(_instance, worker_id: str, duration_s: float,
                      hz: float, torch_profile: bool,
                      driver_wall_s: float) -> Dict[str, Any]:
    """The actor side of :func:`profile` (run by ``_actor.side_call`` on
    the actor's main thread, beside the call threads)."""
    from .capture import capture_profile
    return capture_profile(worker_id, duration_s, hz=hz,
                           torch_profile=torch_profile,
                           driver_wall_s=driver_wall_s)


def profile(duration_s: float = 2.0, hz: float = 67.0,
            torch_profile: bool = False,
            timeout_s: Optional[float] = None,
            profile_dir: Optional[str] = None) -> Dict[str, Any]:
    """Capture a session-wide profile: the driver and every live actor
    this process started sample for ``duration_s``; returns ``{"path",
    "trace", "workers", "unresponsive", "num_events", "seconds"}`` with
    the merged Chrome-trace JSON written under ``profile_dir`` (default
    ``$TMPDIR/ray_tpu_torch/profiles``; load ``path`` in chrome://tracing
    or https://ui.perfetto.dev); ``seconds`` splits the call into the
    driver's own capture, the wait for the actors' records past it, and
    the merge and write.

    Each actor captures on its main thread (``_actor.side_call``), which
    runs no calls, so an actor whose call threads are busy — a replica
    serving, a compiled DAG's loop — still answers; one that does not
    answer within the window plus ``timeout_s`` is listed in
    ``unresponsive``.  ``timeout_s`` defaults to ``COLLECT_TIMEOUT_S``,
    and with ``torch_profile`` to that plus ``TORCH_START_S`` and
    ``TORCH_EXPORT_S_PER_S`` for each second of the window, which cover a
    busy process's profiler start and export.
    The main thread, because ``torch.profiler`` traces the card only when
    its first use in a process is on the thread that imported torch; call
    ``profile`` from the driver's main thread too."""
    from .. import _actor
    from .capture import capture_profile
    from .merge import merge_records, write_trace
    duration_s = max(0.1, float(duration_s))
    if timeout_s is None:
        timeout_s = COLLECT_TIMEOUT_S + (
            TORCH_START_S + TORCH_EXPORT_S_PER_S * duration_s
            if torch_profile else 0.0)
    t0_wall = time.time()
    marks = [time.perf_counter()]
    actors = _actor.live_actors()
    refs = [(a, _actor.side_call(a, _capture_in_actor, a._actor_id,
                                 duration_s, hz, torch_profile, t0_wall))
            for a in actors]
    # The driver samples itself on this thread while the actors capture.
    records = [capture_profile("driver", duration_s, hz=hz,
                               torch_profile=torch_profile,
                               driver_wall_s=t0_wall, is_driver=True)]
    marks.append(time.perf_counter())
    deadline = time.monotonic() + timeout_s
    unresponsive = []
    for a, ref in refs:
        try:
            records.append(_actor.get(
                ref, timeout=max(0.0, deadline - time.monotonic())))
        except Exception:  # noqa: BLE001 - timed out, or the actor died
            unresponsive.append(a._actor_id)
    t1_wall = time.time()
    marks.append(time.perf_counter())
    doc = merge_records(records, meta={
        "duration_s": duration_s, "hz": hz, "driver_t0_wall_s": t0_wall,
        "driver_t1_wall_s": t1_wall, "unresponsive": unresponsive})
    where = profile_dir or os.path.join(tempfile.gettempdir(),
                                        "ray_tpu_torch", "profiles")
    path = write_trace(os.path.join(where,
                                    f"profile-{time.time_ns()}.json"), doc)
    marks.append(time.perf_counter())
    return {"path": path, "trace": doc,
            "workers": [r.get("worker_id") for r in records],
            "unresponsive": unresponsive,
            "num_events": len(doc["traceEvents"]),
            "seconds": {"capture": marks[1] - marks[0],
                        "collect": marks[2] - marks[1],
                        "merge": marks[3] - marks[2]}}


__all__ = ["profile", "fence", "step_phase", "track",
           "install_recompile_detector", "uninstall_recompile_detector"]
