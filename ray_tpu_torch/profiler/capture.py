"""Process-side profile capture: host sampling + a ``torch.profiler``
window (counterpart of ray_tpu/profiler/capture.py).

One half of the on-demand profiler (the other half — fan-out over the
session's actors, collection and merging — is ``profiler.profile`` and
``merge.py``).  ``capture_profile`` runs IN the profiled process: a
pure-Python sampling profiler walks ``sys._current_frames()`` at a fixed
rate (a copy of the JAX module's), and optionally brackets the window
with ``torch.profiler`` in place of JAX's ``jax.profiler`` window: CUDA
activity (every kernel of the process, through CUPTI) where the process
has initialised a card, else CPU ops of every thread where this torch
offers ``profile_all_threads``.

The torch window's Chrome trace is shipped in the record, under the same
byte cap as JAX's artifacts (``MAX_TORCH_ARTIFACT_BYTES``): its events
are compacted to the fields a timeline needs, and where they still exceed
the cap the host-side events go first; kernel events are kept, the
earliest of them where they alone exceed it.  Its
timestamps are put on this process's wall clock (``baseTimeNanoseconds``
plus each event's ``ts``), so the merger shifts them to the driver's
clock like the host samples and folds them into the merged trace (JAX
writes TensorBoard artifacts beside its trace instead).

Clock alignment: the request carries the driver's wall clock at send
time; the capturing process records ``clock_offset_s = local_wall -
driver_wall`` at receipt (bounded above by transit time), and the merger
shifts every event by ``-clock_offset_s`` so the merged trace is in
driver-clock coordinates.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

#: One capture at a time per process: torch.profiler is process-global and
#: overlapping samplers would double the sampling load mid-incident.
_active_lock = threading.Lock()

#: Cap on the torch.profiler trace bytes shipped driver-ward per capture
#: (JAX's ``MAX_JAX_ARTIFACT_BYTES``).
MAX_TORCH_ARTIFACT_BYTES = 8 * 1024 * 1024

#: Trace-event categories a torch window keeps, device side first: when
#: the compacted events exceed the cap, categories are dropped from the
#: end of this list.
_KEEP_CATS = ("kernel", "gpu_memcpy", "gpu_memset", "cuda_runtime",
              "cuda_driver", "cpu_op", "user_annotation")
#: Events farther than this from the window (wall seconds) mean the trace
#: did not carry wall-clock timestamps.
_CLOCK_SLACK_S = 60.0


def _thread_names() -> Dict[int, str]:
    names: Dict[int, str] = {}
    for t in threading.enumerate():
        if t.ident is not None:
            names[t.ident] = t.name
    return names


def _sample_once(skip_ident: int, max_depth: int = 12) -> Dict[int, Dict]:
    """One ``sys._current_frames()`` snapshot: per-thread leaf frame plus
    a bounded stack of ``func (file:line)`` strings, innermost first."""
    out: Dict[int, Dict] = {}
    for tid, frame in sys._current_frames().items():
        if tid == skip_ident:
            continue  # never profile the sampler itself
        stack: List[str] = []
        f = frame
        while f is not None and len(stack) < max_depth:
            code = f.f_code
            stack.append(f"{code.co_name} "
                         f"({os.path.basename(code.co_filename)}:"
                         f"{f.f_lineno})")
            f = f.f_back
        if stack:
            out[tid] = {"leaf": stack[0], "stack": stack}
    return out


def _run_sampler(duration_s: float, hz: float,
                 samples: List[Dict[str, Any]],
                 until: Optional[threading.Event] = None) -> None:
    """Sample for ``duration_s``, and on until ``until`` is set."""
    period = 1.0 / max(1.0, hz)
    ident = threading.get_ident()
    deadline = time.monotonic() + max(0.0, duration_s)
    names = _thread_names()
    refreshed = time.monotonic()
    while time.monotonic() < deadline or (until is not None
                                          and not until.is_set()):
        t0 = time.monotonic()
        threads = _sample_once(ident)
        now_wall = time.time()
        if t0 - refreshed > 0.5:  # new threads appear mid-capture
            names = _thread_names()
            refreshed = t0
        samples.append({
            "t": now_wall,
            "threads": {tid: dict(rec, name=names.get(tid, f"t{tid}"))
                        for tid, rec in threads.items()},
        })
        sleep = period - (time.monotonic() - t0)
        if sleep > 0:
            time.sleep(sleep)


def _torch_events(doc: Dict[str, Any], t0_wall: float,
                  t1_wall: float) -> List[Dict[str, Any]]:
    """A torch.profiler Chrome trace's events on this process's wall clock
    (``ts`` in µs since the epoch), compacted: complete and instant events
    of the kept categories with their name, category, thread and
    duration."""
    raw = [e for e in doc.get("traceEvents", ())
           if e.get("ph") in ("X", "i") and "ts" in e
           and e.get("cat") in _KEEP_CATS]
    if not raw:
        return []
    base_us = float(doc.get("baseTimeNanoseconds") or 0) / 1e3
    first = min(float(e["ts"]) for e in raw) + base_us
    if abs(first / 1e6 - t0_wall) > _CLOCK_SLACK_S + (t1_wall - t0_wall):
        # No wall-clock base in this torch's trace: anchor the first
        # event at the window's start.
        base_us = t0_wall * 1e6 - min(float(e["ts"]) for e in raw)
    out = []
    for e in raw:
        ev = {"name": e.get("name", "?"), "cat": e["cat"], "ph": e["ph"],
              "ts": float(e["ts"]) + base_us, "tid": e.get("tid", 0)}
        if "dur" in e:
            ev["dur"] = float(e["dur"])
        out.append(ev)
    return out


def _fit_cap(events: List[Dict[str, Any]], cap: int):
    """(the JSON of ``events`` within ``cap`` bytes, how many it holds, an
    error or None): host categories are dropped, last kept first, until
    it fits; past that, the kernel events are cut to the earliest that
    fit.  Each event is serialised once to measure it, and the kept ones
    once more to ship them."""
    # An item's bytes in a JSON list: itself and its ", " separator.
    sizes = [len(json.dumps(e)) + 2 for e in events]
    by_cat: Dict[str, int] = {}
    for e, n in zip(events, sizes):
        by_cat[e["cat"]] = by_cat.get(e["cat"], 0) + n
    cats = list(_KEEP_CATS)
    while len(cats) > 1 and 2 + sum(by_cat.get(c, 0) for c in cats) > cap:
        cats.pop()
    dropped = [c for c in _KEEP_CATS if c not in cats]
    kept = [(e, n) for e, n in zip(events, sizes) if e["cat"] in cats]
    n, total = 0, 2
    while n < len(kept) and total + kept[n][1] <= cap:
        total += kept[n][1]
        n += 1
    blob = json.dumps([e for e, _ in kept[:n]]).encode()
    if n < len(kept):
        return blob, n, (f"over the {cap}B cap: only {_KEEP_CATS[0]} "
                         f"events kept, the first {n} of {len(kept)}")
    return blob, n, (f"over the {cap}B cap: dropped {dropped}"
                     if dropped else None)


def _window_config(all_threads: bool) -> Dict[str, Any]:
    """``torch.profiler.profile`` keywords for a window, as far as this
    torch offers them: ``trace_only`` (no Python event objects built at
    the window's end: only the export is read), and, in a process that
    uses no card, ``profile_all_threads`` (CPU ops of every thread; where
    the card is traced its kernels are the timeline, and every serving
    thread's ops would take seconds to gather and exceed the cap)."""
    try:
        from torch._C._profiler import _ExperimentalConfig
    except ImportError:
        return {"all_threads": False}
    for opts in ({"profile_all_threads": all_threads, "trace_only": True},
                 {"profile_all_threads": all_threads}, {}):
        try:
            cfg = _ExperimentalConfig(**opts)
        except TypeError:
            continue
        return {"experimental_config": cfg,
                "all_threads": opts.get("profile_all_threads", False)}
    return {"all_threads": False}


def _torch_profile_window(duration_s: float,
                          on_close=lambda: None) -> Dict[str, Any]:
    """Bracket ``duration_s`` with torch.profiler and ship its events;
    ``on_close()`` runs as the window closes.  CUDA activity is traced only
    where this process already uses a card: a capture must never be the
    thing that initialises CUDA in a process that was not using it."""
    info: Dict[str, Any] = {"attempted": False, "events": b"[]",
                            "num_events": 0, "cuda": False, "bytes": 0,
                            "all_threads": False, "seconds": {},
                            "error": None}
    if "torch" not in sys.modules:
        info["error"] = "torch not imported in this process"
        return info
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        acts.append(ProfilerActivity.CUDA)
        info["cuda"] = True
    info["attempted"] = True
    kw = _window_config(all_threads=not info["cuda"])
    info["all_threads"] = kw.pop("all_threads")
    fd, path = tempfile.mkstemp(prefix="ray_tpu_torchprof_", suffix=".json")
    os.close(fd)
    try:
        t0 = time.time()
        starting = time.perf_counter()
        with profile(activities=acts, **kw) as prof:
            started = time.perf_counter()
            time.sleep(max(0.0, duration_s))
            on_close()
            t1 = time.time()
            stopping = time.perf_counter()
        # The work around the window, by stage: the profiler's start and
        # stop, its export, reading the export back, fitting the events
        # to the cap.
        marks = [time.perf_counter()]
        prof.export_chrome_trace(path)
        marks.append(time.perf_counter())
        with open(path) as f:
            doc = json.load(f)
        events = _torch_events(doc, t0, t1)
        marks.append(time.perf_counter())
        blob, n, info["error"] = _fit_cap(events, MAX_TORCH_ARTIFACT_BYTES)
        marks.append(time.perf_counter())
        info.update(events=blob, num_events=n, bytes=len(blob),
                    seconds={"start": started - starting,
                             "stop": marks[0] - stopping,
                             "export": marks[1] - marks[0],
                             "read": marks[2] - marks[1],
                             "fit": marks[3] - marks[2]})
    except Exception as e:  # noqa: BLE001 — capture is best-effort
        info["error"] = f"{type(e).__name__}: {e}"
    finally:
        try:
            os.unlink(path)
        except OSError:
            pass
    return info


def device_memory_stats() -> List[Dict[str, Any]]:
    """Per-card memory stats from ``torch.cuda.memory_stats`` for each
    visible card (empty where this process has not initialised CUDA)."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_available() \
            or not torch.cuda.is_initialized():
        return []
    out: List[Dict[str, Any]] = []
    try:
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            if not stats:
                continue
            out.append({
                "device": f"cuda:{i}",
                "bytes_in_use": stats.get("allocated_bytes.all.current"),
                "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
                "bytes_limit": torch.cuda.get_device_properties(
                    i).total_memory,
            })
    except Exception:  # noqa: BLE001 — stats are garnish
        return out
    return out


def capture_profile(worker_id: str, duration_s: float,
                    hz: float = 67.0, torch_profile: bool = False,
                    driver_wall_s: Optional[float] = None,
                    is_driver: bool = False) -> Dict[str, Any]:
    """Profile THIS process for ``duration_s``; returns the capture
    record shipped to the driver (see merge.py for the shape consumed).
    Blocks for the duration — callers run it off their call threads."""
    recv_wall = time.time()
    # Wall-minus-wall on purpose: this measures the CLOCK OFFSET between
    # two processes (monotonic clocks have unrelated bases).
    offset = 0.0
    if driver_wall_s:
        offset = recv_wall - driver_wall_s
    if not _active_lock.acquire(blocking=False):
        return {"worker_id": worker_id, "pid": os.getpid(),
                "is_driver": is_driver, "error": "capture already running",
                "clock_offset_s": offset, "samples": []}
    try:
        samples: List[Dict[str, Any]] = []
        if torch_profile:
            # The torch window sleeps for the duration, so the host
            # sampler runs on its own thread alongside it, from now until
            # the window closes: a process's first window opens seconds
            # late (CUPTI's setup), and the samples cover it too.
            closed = threading.Event()
            t = threading.Thread(target=_run_sampler,
                                 args=(duration_s, hz, samples, closed),
                                 name="profile-sampler", daemon=True)
            t.start()
            torch_info = _torch_profile_window(duration_s,
                                               on_close=closed.set)
            closed.set()
            t.join(timeout=duration_s + 5.0)
        else:
            _run_sampler(duration_s, hz, samples)
            torch_info = {"attempted": False, "events": b"[]",
                          "num_events": 0, "cuda": False, "bytes": 0,
                          "error": None}
        return {
            "worker_id": worker_id,
            "pid": os.getpid(),
            "is_driver": is_driver,
            "clock_offset_s": offset,
            "duration_s": duration_s,
            "hz": hz,
            "samples": samples,
            "torch_profile": torch_info,
            "memory": device_memory_stats(),
            "error": None,
        }
    finally:
        _active_lock.release()
