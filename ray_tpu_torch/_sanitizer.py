"""Runtime resource-leak sanitizer (``RAY_TPU_SANITIZE=1``; a copy of
``ray_tpu/_private/sanitizer.py`` over the port's tiers).

The static RT3xx rules prove per-function release discipline; this is
the runtime twin.  When enabled (the env var at ``import ray_tpu_torch``,
or :func:`install` directly) it keeps lightweight registries of:

* **framework threads** — ``threading.Thread.start`` is patched to
  record a creation-site stack for every thread started *from* the
  ``ray_tpu_torch`` tree (test/user threads are ignored); :func:`spawn`
  is the sanctioned fire-and-forget spawn path (RT301 recognizes it as
  tracked registration),
* **pins** — the object store's pins (``SharedMemoryStore.try_pin`` /
  ``try_unpin``: shm segments and CUDA IPC exports) report here,
* **tracked file handles** — checkpoint writers open through
  :func:`tracked_open`,
* **named actors** — a framework-created named actor reports its name
  and creation site; session-lifetime-by-design names (the serve
  controller) are declared with :func:`session_scoped`.

:func:`snapshot` (called by ``init()`` and by the first actor's session)
records the baseline; ``ray_tpu_torch.shutdown()`` calls
:func:`pre_shutdown` (named actors are inspected before their processes
are killed) and, once the tiers are down, :func:`check_after_shutdown` —
a nonzero diff raises :class:`LeakError` listing every leaked resource
with its creation site.  The test suite turns it on for every test, so
each test that calls ``shutdown()`` doubles as a leak test.

Two sanitizers in one process (the JAX package's and this one, as in the
parity tests) chain: each install wraps whatever ``Thread.start`` is at
that moment, and an uninstall unhooks only a wrapper still on top; one
that another wrapper has covered stays in the chain as a pass-through.
The wrapper's frames carry a file name outside this package, so a
sanitizer walking the stack for a creation site (the JAX package's
counts any path under ``ray_tpu*``) does not take the wrapper itself for
the site.

Scope: the check runs in the *driver* process (worker-process threads
die with their process).  Overhead when disabled is zero — nothing is
patched; when enabled it is one dict write per tracked event.
"""

from __future__ import annotations

import fnmatch
import os
import sys
import threading
import time
import weakref
from typing import Any, Dict, List, Optional

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_PKG_PREFIX = _PKG_DIR + os.sep

#: Frames kept per creation-site summary.
_STACK_DEPTH = 5

#: Post-shutdown grace for framework threads to wind down before a
#: still-alive one counts as leaked.
DEFAULT_GRACE_S = 4.0

#: The file name the thread-start wrapper's frames carry (see above).
_WRAPPER_FILE = "<ray_tpu_torch sanitizer wrapper>"


class LeakError(RuntimeError):
    """Raised at shutdown when the sanitizer's diff is nonzero."""


class _State:
    def __init__(self) -> None:
        self.mu = threading.Lock()
        self.installed = False
        # thread -> {"name", "site", "stack", "tracked"} (weak keys: a
        # dead, collected thread can never be reported).
        self.threads: "weakref.WeakKeyDictionary[threading.Thread, dict]" \
            = weakref.WeakKeyDictionary()
        self.pins: Dict[str, dict] = {}          # object id -> info
        self.files: Dict[int, dict] = {}         # id(wrapper) -> info
        self.named_actors: Dict[str, dict] = {}  # "ns/name" -> info
        self.session_patterns: List[str] = []
        self.thread_allow: List[str] = []
        self.armed = False                       # a baseline is taken
        self.baseline_threads: set = set()       # Thread idents
        self.baseline_pins: set = set()
        self.baseline_files: set = set()
        self.baseline_named: set = set()


_state = _State()

_SELF_FILE = os.path.abspath(__file__)

#: Frames walked looking for the creation site (a bounded
#: ``sys._getframe`` walk: a full ``traceback.extract_stack()`` per
#: thread start costs ~100 µs under deep test stacks).
_WALK_DEPTH = 14


def _site_and_stack():
    """(innermost ray_tpu_torch frame "file:line", short outer->inner
    stack) — or ``(None, stack)`` when no frame is inside the package
    (not framework-created)."""
    frames: List[str] = []
    site = None
    try:
        f = sys._getframe(2)
    except ValueError:
        f = None
    depth = 0
    while f is not None and depth < _WALK_DEPTH:
        fn = f.f_code.co_filename
        frames.append(f"{os.path.basename(fn)}:{f.f_lineno} "
                      f"in {f.f_code.co_name}")
        if site is None and fn.startswith(_PKG_PREFIX) and fn != _SELF_FILE:
            site = f"{os.path.relpath(fn, os.path.dirname(_PKG_DIR))}" \
                   f":{f.f_lineno}"
        f = f.f_back
        depth += 1
    frames.reverse()
    return site, frames[-_STACK_DEPTH:]


# -- install ---------------------------------------------------------------


def _record_start(t: threading.Thread) -> None:
    if _state.installed and t not in _state.threads:
        # Threads registered by spawn() keep their entry (and its
        # tracked=True flag) — this path only records direct
        # Thread.start() calls made from framework code.
        site, stack = _site_and_stack()
        if site is not None:
            with _state.mu:
                _state.threads[t] = {
                    "name": t.name, "site": site, "stack": stack,
                    "tracked": False, "time": time.time()}


def _make_wrapper(prev):
    def start(self):
        _record_start(self)
        prev(self)
    start.__code__ = start.__code__.replace(co_filename=_WRAPPER_FILE)
    start._rtt_sanitizer_prev = prev
    return start


def install() -> None:
    """Wrap ``threading.Thread.start`` to record framework creation
    sites.  Idempotent; :func:`uninstall` undoes it."""
    with _state.mu:
        if _state.installed:
            return
        _state.installed = True
        cur = threading.Thread.start
        if getattr(cur, "_rtt_sanitizer_prev", None) is None:
            threading.Thread.start = _make_wrapper(cur)  # type: ignore


def uninstall() -> None:
    """Stop recording; unhook the wrapper if it is still on top (one that
    another package's wrapper covers stays, as a pass-through)."""
    with _state.mu:
        if not _state.installed:
            return
        _state.installed = False
        prev = getattr(threading.Thread.start, "_rtt_sanitizer_prev", None)
        if prev is not None:
            threading.Thread.start = prev  # type: ignore[assignment]


def is_enabled() -> bool:
    return _state.installed


# -- spawn helper ----------------------------------------------------------


def spawn(target, *, name: Optional[str] = None, args: tuple = (),
          kwargs: Optional[dict] = None,
          daemon: bool = True) -> threading.Thread:
    """Create, register and start a framework background thread — THE
    sanctioned fire-and-forget spawn (RT301 counts it as registration
    in a tracked set; a bare ``threading.Thread(...).start()`` with no
    reachable join is a lint finding)."""
    t = threading.Thread(target=target, name=name, args=args,
                         kwargs=kwargs or {}, daemon=daemon)
    if _state.installed:
        site, stack = _site_and_stack()
        with _state.mu:
            _state.threads[t] = {"name": t.name, "site": site or "<app>",
                                 "stack": stack, "tracked": True,
                                 "time": time.time()}
    t.start()
    return t


def allow_thread(name_prefix: str) -> None:
    """Declare a thread-name prefix that may legitimately outlive
    ``shutdown()`` (use sparingly; prefer joining at teardown)."""
    with _state.mu:
        if name_prefix not in _state.thread_allow:
            _state.thread_allow.append(name_prefix)


# -- pins ------------------------------------------------------------------


def note_pin(object_id: str) -> None:
    if not _state.installed:
        return
    site, stack = _site_and_stack()
    with _state.mu:
        info = _state.pins.setdefault(
            object_id, {"count": 0, "site": site or "<app>",
                        "stack": stack, "time": time.time()})
        info["count"] += 1


def note_unpin(object_id: str) -> None:
    if not _state.installed:
        return
    with _state.mu:
        info = _state.pins.get(object_id)
        if info is None:
            return
        info["count"] -= 1
        if info["count"] <= 0:
            del _state.pins[object_id]


# -- tracked files ---------------------------------------------------------


class TrackedFile:
    """Thin wrapper whose ``close`` unregisters; returned by
    :func:`tracked_open`."""

    def __init__(self, f, info: dict):
        self._f = f
        self._info = info

    def __getattr__(self, name: str) -> Any:
        return getattr(self._f, name)

    def __enter__(self) -> "TrackedFile":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def __iter__(self):
        return iter(self._f)

    def close(self) -> None:
        with _state.mu:
            _state.files.pop(id(self), None)
        self._f.close()


def tracked_open(path: str, mode: str = "r", **kw):
    """``open()`` that registers the handle while the sanitizer is on
    (checkpoint writers use this, so a handle that never closes shows up
    in the shutdown diff with its opening site)."""
    f = open(path, mode, **kw)
    if not _state.installed:
        return f
    site, stack = _site_and_stack()
    tf = TrackedFile(f, {})
    with _state.mu:
        _state.files[id(tf)] = {"path": path, "mode": mode,
                                "site": site or "<app>", "stack": stack,
                                "time": time.time()}
    return tf


# -- named actors ----------------------------------------------------------


def _framework_created() -> Optional[str]:
    """Innermost *subsystem* frame (a module of a subpackage of
    ray_tpu_torch, or a top-level module whose name does not start with
    ``_``) on the current stack, or None.  User code creating a named
    actor goes straight through the private actor machinery; framework
    subsystems (serve, llm, ...) add their own frame."""
    f = sys._getframe(2)
    while f is not None:
        fn = os.path.abspath(f.f_code.co_filename)
        if fn.startswith(_PKG_PREFIX):
            rel = os.path.relpath(fn, _PKG_DIR)
            top = rel.split(os.sep)[0]
            if not top.startswith("_"):
                return f"ray_tpu_torch/{rel}:{f.f_lineno}"
        f = f.f_back
    return None


def note_named_actor(name: str, namespace: str,
                     class_name: Optional[str] = None) -> None:
    """Record a *framework-created* named actor.  User-created named
    actors are their owner's business — ``shutdown()`` reaps them by
    design; only subsystem-owned ones must be cleaned up (or declared
    :func:`session_scoped`) and count as leaks."""
    if not _state.installed or not name:
        return
    fw_site = _framework_created()
    if fw_site is None:
        return
    _, stack = _site_and_stack()
    with _state.mu:
        _state.named_actors[f"{namespace}/{name}"] = {
            "name": name, "namespace": namespace,
            "class_name": class_name, "site": fw_site,
            "stack": stack, "time": time.time()}


def session_scoped(name: str) -> None:
    """Declare a named actor as session-lifetime by design (fnmatch
    pattern): it will not be reported at shutdown."""
    with _state.mu:
        if name not in _state.session_patterns:
            _state.session_patterns.append(name)


# -- snapshot / check ------------------------------------------------------


def snapshot(*, first: bool = False) -> None:
    """Record the baseline at session start: resources alive NOW belong
    to the environment (or to a previous, already-reported session) and
    are never re-reported.  ``first``: only when no baseline is armed
    (the actor tier's session, which may start before or after
    ``init()``)."""
    if not _state.installed:
        return
    with _state.mu:
        if first and _state.armed:
            return
        _state.armed = True
        _state.baseline_threads = {
            t.ident for t in threading.enumerate() if t.ident is not None}
        _state.baseline_pins = set(_state.pins)
        _state.baseline_files = set(_state.files)
        _state.baseline_named = set(_state.named_actors)


def _named_alive(name: str, namespace: str) -> bool:
    from . import _actor
    try:
        _actor.get_actor(name, namespace)
    except Exception:  # noqa: BLE001 - none, dead, or no store any more
        return False
    return True


def _live_named() -> List[dict]:
    """Framework-created named actors still alive, minus session-scoped
    and baseline names — must run BEFORE shutdown kills the actors."""
    out: List[dict] = []
    with _state.mu:
        recorded = {k: dict(v) for k, v in _state.named_actors.items()}
        baseline = set(_state.baseline_named)
        patterns = list(_state.session_patterns)
    for key, rec in recorded.items():
        if key in baseline:
            continue
        name, ns = rec["name"], rec["namespace"]
        if any(fnmatch.fnmatch(name, pat) for pat in patterns):
            continue
        if not _named_alive(name, ns):
            continue
        rec["kind"] = "named_actor"
        out.append(rec)
    return out


def pre_shutdown(grace_s: float = 2.0) -> List[dict]:
    """First half of the shutdown gate (returns pending named-actor
    leaks; pass to :func:`check_after_shutdown`).  A subsystem that
    killed its actor moments ago may not see it dead yet, so leaks get a
    short settle window."""
    if not _state.installed:
        return []
    leaks = _live_named()
    deadline = time.monotonic() + grace_s
    while leaks and time.monotonic() < deadline:
        time.sleep(0.05)
        leaks = _live_named()
    return leaks


def _leaked_now() -> List[dict]:
    out: List[dict] = []
    with _state.mu:
        for t, info in list(_state.threads.items()):
            if not t.is_alive() or t.ident in _state.baseline_threads:
                continue
            if any(t.name.startswith(p) for p in _state.thread_allow):
                continue
            rec = dict(info)
            rec["kind"] = "thread"
            rec["alive_thread"] = t
            out.append(rec)
        for oid, info in _state.pins.items():
            if oid in _state.baseline_pins:
                continue
            rec = dict(info)
            rec["kind"] = "pin"
            rec["object_id"] = oid
            out.append(rec)
        for fid, info in _state.files.items():
            if fid in _state.baseline_files:
                continue
            rec = dict(info)
            rec["kind"] = "file"
            out.append(rec)
    return out


def check_after_shutdown(pre: Optional[List[dict]] = None,
                         grace_s: Optional[float] = None) -> None:
    """Second half of the shutdown gate: wait up to ``grace_s`` (module
    default: :data:`DEFAULT_GRACE_S`) for framework threads to wind
    down, then raise :class:`LeakError` on any nonzero diff."""
    if not _state.installed:
        return
    with _state.mu:
        _state.armed = False
    if grace_s is None:
        grace_s = DEFAULT_GRACE_S
    pre = pre or []
    deadline = time.monotonic() + grace_s
    leaks = _leaked_now()
    # Only threads can resolve themselves (by exiting); wait the grace
    # out for them, not for pins/files that cannot un-leak.
    while any(rec["kind"] == "thread" for rec in leaks) and \
            time.monotonic() < deadline:
        time.sleep(0.05)
        leaks = _leaked_now()
    leaks = pre + leaks
    for rec in leaks:
        rec.pop("alive_thread", None)
    if leaks:
        raise LeakError(format_report(leaks))


def format_report(leaks: List[dict]) -> str:
    lines = [f"resource leak sanitizer: {len(leaks)} leaked resource(s) "
             f"at shutdown (RAY_TPU_SANITIZE=1)"]
    for rec in leaks:
        kind = rec.get("kind")
        if kind == "thread":
            head = f"[thread] {rec.get('name')} created at " \
                   f"{rec.get('site')}"
        elif kind == "pin":
            head = f"[pin] object {rec.get('object_id', '')[:16]} pinned " \
                   f"at {rec.get('site')}"
        elif kind == "file":
            head = f"[file] {rec.get('path')} ({rec.get('mode')}) opened " \
                   f"at {rec.get('site')}"
        else:
            head = f"[named_actor] {rec.get('namespace')}/" \
                   f"{rec.get('name')} ({rec.get('class_name')}) " \
                   f"created at {rec.get('site')}"
        lines.append("  " + head)
        for fr in rec.get("stack", [])[-_STACK_DEPTH:]:
            lines.append("      " + fr)
    lines.append("  (declare intentional session-lifetime resources via "
                 "_sanitizer.session_scoped/allow_thread, or fix the "
                 "missing release)")
    return "\n".join(lines)


def report() -> Dict[str, Any]:
    """Every currently-tracked live resource with its creation site."""
    with _state.mu:
        threads = [
            {"name": t.name, "site": info.get("site"),
             "tracked": info.get("tracked"), "stack": info.get("stack")}
            for t, info in list(_state.threads.items()) if t.is_alive()]
        return {
            "enabled": _state.installed,
            "pid": os.getpid(),
            "threads": threads,
            "pins": [{"object_id": oid, "count": i.get("count"),
                      "site": i.get("site")}
                     for oid, i in _state.pins.items()],
            "files": [{"path": i.get("path"), "site": i.get("site")}
                      for i in _state.files.values()],
            "named_actors": [
                {"name": i.get("name"), "namespace": i.get("namespace"),
                 "class_name": i.get("class_name"), "site": i.get("site")}
                for i in _state.named_actors.values()],
            "session_scoped": list(_state.session_patterns),
        }


def _reset_for_tests() -> None:
    """Drop registries and baseline (test isolation; does not change
    installed state)."""
    with _state.mu:
        _state.threads = weakref.WeakKeyDictionary()
        _state.pins.clear()
        _state.files.clear()
        _state.named_actors.clear()
        _state.armed = False
        _state.baseline_threads = set()
        _state.baseline_pins = set()
        _state.baseline_files = set()
        _state.baseline_named = set()
