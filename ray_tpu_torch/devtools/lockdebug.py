"""Opt-in runtime lock instrumentation: order detector + contention
profiler (a copy of ray_tpu/devtools/lockdebug.py).

Two modes share one set of wrappers around ``threading.Lock`` /
``threading.RLock``:

* ``RAY_TPU_DEBUG_LOCKS=1`` (``install()``) — the heavyweight
  *order detector*.  Static analysis (RT201) catches blocking calls
  lexically inside a ``with lock:`` block; orderings that only exist at
  runtime — lock A taken in one module, lock B in another, reversed on
  a third path — need instrumentation.  The debug wrappers maintain a
  per-thread stack of held locks, a process-wide acquisition-order
  graph (a new edge that closes a cycle is a potential AB/BA deadlock,
  recorded with both acquisition sites), and a patched ``time.sleep``
  that records sleeping while holding any instrumented lock.

* ``RAY_TPU_LOCK_PROFILE=1`` (``install_profile()``) — the lightweight
  *contention profiler*.  Every instrumented lock keeps per-creation-
  site wait-time and hold-time histograms (fixed log buckets), counts
  of acquires and contended acquires, and max/total times.  Stats are
  mutated only while the profiled lock itself is held, so the counters
  need no extra synchronization; the uncontended fast path costs one
  non-blocking try-acquire plus two clock reads per acquire/release
  pair.  Roughly every 64th release also publishes a sampled
  observation to the ``ray_tpu_lock_wait_seconds`` /
  ``ray_tpu_lock_hold_seconds`` catalog series (post-release, with a
  thread-local recursion guard so telemetry's own locks cannot
  re-enter).

The debug wrappers collect the same contention stats, so either mode
feeds ``contention_report()``.  Only locks created *after* install are
instrumented (the wrappers replace the constructors, not live locks).
Beside the decade histograms each lock keeps its latest contended waits
and sampled holds (``_RAW_KEEP`` of each), from which the report gives
``wait_p50_s``/``wait_p99_s`` over every acquire (an uncontended one
waits 0), the same over contended acquires alone, and ``hold_p50_s``.

Findings land in ``report()`` / ``contention_report()``;
``format_contention()`` renders the contention document as a table.

Two instrumentations in one process (the JAX package's and this one, as
in the parity tests) patch the same ``threading.Lock``/``RLock`` and
``time.sleep``.  This module saves what was in force when it patched
(the other package's wrappers, or the real primitives), builds its own
locks' inner locks from that, and on uninstall restores an attribute only
where its own wrapper is still the one in force: whichever order the two
were installed in, the other's wrappers stay.  Its own bookkeeping uses
``_thread``'s primitives, never a patched constructor.
"""

from __future__ import annotations

import _thread
import os
import sys
import threading
import time
import traceback
import weakref
from typing import Any, Dict, List, Optional, Tuple

#: The interpreter's own primitives, for this module's bookkeeping.
_raw_lock = _thread.allocate_lock
_pc = time.perf_counter
#: ``time.sleep`` at import: the fallback of a sleep wrapper outliving its
#: patch.
_import_sleep = time.sleep

_installed = False
_prof_installed = False
#: (Lock, RLock, sleep) in force when this module patched, or None while
#: it has not.
_prev: Optional[Tuple[Any, Any, Any]] = None

#: Contended waits and sampled holds kept per lock for the quantiles.
_RAW_KEEP = 4096

#: Frames of acquisition stack kept per new edge / finding.
_STACK_DEPTH = 6

#: Histogram bucket upper bounds (seconds); one overflow bucket rides
#: at the end.  Decade buckets from 1µs keep the arrays tiny (8 ints).
_PROF_BOUNDS = (1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0)

#: Publish one sampled (wait, hold) observation to telemetry every
#: N-th release of a given lock.
_PUBLISH_EVERY = 64

#: Measured waits above this count as contended when the non-blocking
#: fast path was skipped (timeout/non-blocking acquires).
_CONTENDED_S = 1e-5


class _State:
    def __init__(self):
        self.mu = _raw_lock()
        self.seq = 0
        # edge (holder_name, acquired_name) -> info dict
        self.edges: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self.findings: List[Dict[str, Any]] = []
        self.seen_cycles: set = set()
        self.seen_blocking: set = set()
        # (owner_tid, lock_id) for plain Locks released by a thread
        # other than their acquirer (legal handoff pattern): the owner's
        # held list is pruned lazily at its next acquire/sleep so the
        # phantom entry cannot mint bogus edges or sleep findings.
        self.foreign_released: set = set()


_state = _State()
_tls = threading.local()

# Every instrumented lock (debug or profile) registers here so
# contention_report() can aggregate per creation site.  WeakSet: dead
# locks drop out with their stats.
_reg_mu = _raw_lock()
_registry: "weakref.WeakSet" = weakref.WeakSet()


def _held() -> List[Tuple["_DebugLockBase", int]]:
    """This thread's held-lock stack: (lock, depth) entries, pruned of
    locks another thread has since released on our behalf."""
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = []
    if h and _state.foreign_released:
        tid = threading.get_ident()
        with _state.mu:
            doomed = {lid for t, lid in _state.foreign_released
                      if t == tid}
            if doomed:
                _state.foreign_released -= {(tid, lid) for lid in doomed}
        if doomed:
            h[:] = [(l, d) for l, d in h if id(l) not in doomed]
    return h


def _caller_site(skip: int = 2) -> str:
    """First frame OUTSIDE this module (so with-statement acquires point
    at the user line, not at __enter__)."""
    try:
        f = sys._getframe(skip)
        while f is not None and f.f_code.co_filename == __file__:
            f = f.f_back
        if f is None:
            return "<unknown>"
        return f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"
    except Exception:
        return "<unknown>"


def _short_stack() -> List[str]:
    return [ln.strip().replace("\n", " | ")
            for ln in traceback.format_stack()[-_STACK_DEPTH - 2:-2]]


def _find_cycle(start: str, target: str) -> Optional[List[str]]:
    """Path ``start -> ... -> target`` through the edge graph (the new
    edge target->start then closes the cycle)."""
    adj: Dict[str, List[str]] = {}
    for a, b in _state.edges:
        adj.setdefault(a, []).append(b)
    path = [start]
    seen = {start}

    def dfs(node: str) -> bool:
        if node == target:
            return True
        for nxt in adj.get(node, ()):
            if nxt in seen:
                continue
            seen.add(nxt)
            path.append(nxt)
            if dfs(nxt):
                return True
            path.pop()
        return False

    return path if dfs(start) else None


def _note_acquire(lock: "_DebugLockBase") -> None:
    held = _held()
    for i, (prev, depth) in enumerate(held):
        if prev is lock:  # reentrant re-acquire: no new ordering info
            held[i] = (prev, depth + 1)
            return
    site = _caller_site(3)
    new_edges = []
    with _state.mu:
        for prev, _depth in held:
            key = (prev.name, lock.name)
            info = _state.edges.get(key)
            if info is None:
                _state.edges[key] = {
                    "holder": prev.name, "acquired": lock.name,
                    "thread": threading.current_thread().name,
                    "site": site, "stack": _short_stack(), "count": 1}
                new_edges.append(key)
            else:
                info["count"] += 1
        for a, b in new_edges:
            # b already reaches a through older edges? then a->b closes
            # a cycle: two threads interleaving those orders deadlock.
            cycle = _find_cycle(b, a)
            if not cycle:
                continue
            cycle_key = frozenset(cycle)
            if cycle_key in _state.seen_cycles:
                continue
            _state.seen_cycles.add(cycle_key)
            _state.findings.append({
                "kind": "lock_cycle",
                "cycle": cycle + [b],
                "edges": [dict(_state.edges[e])
                          for e in _state.edges
                          if e[0] in cycle_key and e[1] in cycle_key],
                "thread": threading.current_thread().name,
                "site": site,
            })
    held.append((lock, 1))


def _note_release(lock: "_DebugLockBase") -> None:
    held = _held()
    for i in range(len(held) - 1, -1, -1):
        prev, depth = held[i]
        if prev is lock:
            if depth > 1:
                held[i] = (prev, depth - 1)
            else:
                del held[i]
            return


# -- contention stats -------------------------------------------------------


class _Stats:
    """Per-lock wait/hold accounting.  Mutated only by code that holds
    the instrumented lock (post-acquire / pre-release), so no extra
    synchronization; report-time reads are advisory snapshots.

    Cost model (the <2% overhead budget): waits are timed only on the
    CONTENDED path — the uncontended fast path's failed non-blocking
    try IS the contention detector and needs no clock, so its zero
    waits are backfilled into bucket 0 at report time.  Holds are
    timed on a 1-in-8 acquire sample (``hold_samples`` counts them);
    totals are scaled back up by the report."""

    __slots__ = ("acquires", "contended", "wait_total", "wait_max",
                 "hold_total", "hold_max", "hold_samples",
                 "wait_hist", "hold_hist", "last_wait", "wait_raw",
                 "hold_raw")

    def __init__(self):
        self.acquires = 0
        self.contended = 0
        self.wait_total = 0.0
        self.wait_max = 0.0
        self.hold_total = 0.0
        self.hold_max = 0.0
        self.hold_samples = 0
        self.wait_hist = [0] * (len(_PROF_BOUNDS) + 1)
        self.hold_hist = [0] * (len(_PROF_BOUNDS) + 1)
        self.last_wait = 0.0
        self.wait_raw: List[float] = []
        self.hold_raw: List[float] = []


def _keep(raw: List[float], n: int, value: float) -> None:
    """The latest ``_RAW_KEEP`` values, as a ring (``n``: values seen)."""
    if len(raw) < _RAW_KEEP:
        raw.append(value)
    else:
        raw[(n - 1) % _RAW_KEEP] = value


from bisect import bisect_left as _bidx  # noqa: E402 (bucket index)


def _maybe_publish(site: str, wait: float, hold: float) -> None:
    """Sampled telemetry publish, post-release.  The TLS guard stops
    telemetry's own (possibly instrumented) locks from re-entering."""
    if getattr(_tls, "publishing", False):
        return
    _tls.publishing = True
    try:
        from ray_tpu_torch.util import telemetry
        tags = {"site": site}
        telemetry.observe("ray_tpu_lock_wait_seconds", wait, tags=tags)
        telemetry.observe("ray_tpu_lock_hold_seconds", hold, tags=tags)
    except Exception:
        pass
    finally:
        _tls.publishing = False


class _InstrumentedBase:
    """Shared machinery: creation-site naming, contention stats, and
    the acquire/release timing protocol.  The profile wrappers use it
    directly; the debug wrappers layer the order graph on top."""

    _kind = "Lock"

    def __init__(self):
        with _state.mu:
            _state.seq += 1
            n = _state.seq
        self._inner = self._make_inner()
        site = _caller_site(2)
        self.site = site
        self.name = f"{self._kind}#{n}@{site}"
        self._stats = _Stats()
        self._depth = 0
        self._t_acq = 0.0
        with _reg_mu:
            _registry.add(self)

    def _make_inner(self):
        return (_prev[0] if _prev else _thread.allocate_lock)()

    def acquire(self, blocking=True, timeout=-1):
        # HOT PATH: an uncontended default acquire does one failed-free
        # non-blocking try, a couple of attribute ops, and (1 in 8) a
        # clock read — that's the whole <2% overhead budget.
        if blocking and timeout == -1:
            if self._inner.acquire(False):
                d = self._depth
                if d:  # reentrant re-acquire (RLock): outermost only
                    self._depth = d + 1
                    return True
                self._depth = 1
                st = self._stats
                n = st.acquires + 1
                st.acquires = n
                if not n & 7:  # sampled hold timing
                    self._t_acq = _pc()
                return True
            # Contended: the wait itself amortizes the clock reads.
            t0 = _pc()
            self._inner.acquire()
            wait = _pc() - t0
            got = True
        else:
            t0 = _pc()
            got = self._inner.acquire(blocking, timeout)
            if not got:
                return False
            wait = _pc() - t0
            d = self._depth
            if d:
                self._depth = d + 1
                return True
        self._depth = 1
        st = self._stats
        st.acquires += 1
        if wait > _CONTENDED_S:
            st.contended += 1
        st.wait_total += wait
        if wait > st.wait_max:
            st.wait_max = wait
        st.wait_hist[_bidx(_PROF_BOUNDS, wait)] += 1
        st.last_wait = wait
        if wait > _CONTENDED_S:
            _keep(st.wait_raw, st.contended, wait)
        self._t_acq = _pc()  # contended holds are always timed
        return got

    def release(self):
        d = self._depth - 1
        if d > 0:  # reentrant: lock stays held
            self._depth = d
            self._inner.release()
            return
        self._depth = 0
        t = self._t_acq
        if not t:  # unsampled hold: nothing to finalize
            self._inner.release()
            return
        self._t_acq = 0.0
        hold = _pc() - t
        st = self._stats
        n = st.hold_samples + 1
        st.hold_samples = n
        st.hold_total += hold
        if hold > st.hold_max:
            st.hold_max = hold
        st.hold_hist[_bidx(_PROF_BOUNDS, hold)] += 1
        _keep(st.hold_raw, n, hold)
        self._inner.release()
        if not n & 7:  # ~every 64th acquire (1/8 of 1/8-sampled holds)
            _maybe_publish(self.site, st.last_wait, hold)

    # Condition support (RLock wrappers): finalize the hold across a
    # cond.wait() release and measure the re-acquire wait on wakeup.
    def _prof_release_save(self) -> int:
        t = self._t_acq
        if t:
            self._t_acq = 0.0
            hold = _pc() - t
            st = self._stats
            st.hold_samples += 1
            st.hold_total += hold
            if hold > st.hold_max:
                st.hold_max = hold
            st.hold_hist[_bidx(_PROF_BOUNDS, hold)] += 1
            _keep(st.hold_raw, st.hold_samples, hold)
        depth = self._depth
        self._depth = 0
        return depth

    def _prof_acquire_restore(self, depth: int, wait: float) -> None:
        st = self._stats
        st.acquires += 1
        if wait > _CONTENDED_S:
            st.contended += 1
        st.wait_total += wait
        if wait > st.wait_max:
            st.wait_max = wait
        st.wait_hist[_bidx(_PROF_BOUNDS, wait)] += 1
        st.last_wait = wait
        if wait > _CONTENDED_S:
            _keep(st.wait_raw, st.contended, wait)
        self._t_acq = _pc()  # post-wait holds are always timed
        self._depth = depth

    # `with lock:` is THE hot usage: alias __enter__ straight to
    # acquire (the context manager protocol ignores the return value)
    # so the pair costs two Python frames, not four.
    __enter__ = acquire

    def __exit__(self, t, v, tb):
        self.release()
        return False

    def locked(self):
        fn = getattr(self._inner, "locked", None)
        return fn() if fn is not None else False

    def __repr__(self):
        return f"<{type(self).__name__} {self.name}>"


class _ProfileLock(_InstrumentedBase):
    """Contention-profiling Lock: stats only, no order graph."""

    _kind = "Lock"


class _ProfileRLock(_InstrumentedBase):
    """Contention-profiling RLock; forwards the protocol Condition uses
    so ``threading.Condition(rlock)`` keeps exact reentrant semantics."""

    _kind = "RLock"

    def _make_inner(self):
        return (_prev[1] if _prev else _thread.RLock)()

    def _is_owned(self):
        return self._inner._is_owned()

    def _release_save(self):
        depth = self._prof_release_save()
        return (self._inner._release_save(), depth)

    def _acquire_restore(self, state):
        saved, depth = state
        t0 = _pc()
        self._inner._acquire_restore(saved)
        self._prof_acquire_restore(depth, _pc() - t0)


# -- debug (order-detector) wrappers ----------------------------------------


class _DebugLockBase(_InstrumentedBase):
    def acquire(self, blocking=True, timeout=-1):
        got = _InstrumentedBase.acquire(self, blocking, timeout)
        if got:
            _note_acquire(self)
        return got

    # Re-alias: `__enter__ = acquire` binds the function at class-body
    # time, so each override must rebind or `with lock:` would skip it.
    __enter__ = acquire

    def release(self):
        _note_release(self)
        _InstrumentedBase.release(self)


class _DebugLock(_DebugLockBase):
    _kind = "Lock"

    # Unlike RLock, a plain Lock may legally be released by a thread
    # that did not acquire it (handoff/signal pattern).  Track the
    # acquiring thread so a foreign release queues a prune of the
    # owner's held list instead of silently leaving a phantom entry.

    def acquire(self, blocking=True, timeout=-1):
        # Wrapper delegation, not a lock acquisition of our own:
        # acquire/release pairing is the CALLER's obligation.
        got = _DebugLockBase.acquire(  # ray-tpu: noqa[RT301]
            self, blocking, timeout)
        if got:
            self._owner_ident = threading.get_ident()
        return got

    __enter__ = acquire

    def release(self):
        owner = getattr(self, "_owner_ident", None)
        self._owner_ident = None
        if owner is not None and owner != threading.get_ident():
            with _state.mu:
                _state.foreign_released.add((owner, id(self)))
            _InstrumentedBase.release(self)
        else:
            _note_release(self)
            _InstrumentedBase.release(self)


class _DebugRLock(_DebugLockBase):
    """RLock wrapper: also forwards the protocol Condition uses so
    ``threading.Condition(rlock)`` keeps exact reentrant semantics."""

    _kind = "RLock"

    def _make_inner(self):
        return (_prev[1] if _prev else _thread.RLock)()

    def _is_owned(self):
        return self._inner._is_owned()

    def _release_save(self):
        _note_release(self)
        depth = self._prof_release_save()
        return (self._inner._release_save(), depth)

    def _acquire_restore(self, state):
        saved, depth = state
        t0 = _pc()
        self._inner._acquire_restore(saved)
        self._prof_acquire_restore(depth, _pc() - t0)
        _note_acquire(self)


def _debug_sleep(seconds):
    held = _held()
    if held:
        site = _caller_site(2)
        key = (site, tuple(l.name for l, _d in held))
        with _state.mu:
            if key not in _state.seen_blocking:
                _state.seen_blocking.add(key)
                _state.findings.append({
                    "kind": "blocking_under_lock",
                    "blocking_call": f"time.sleep({seconds!r})",
                    "held_locks": [l.name for l, _d in held],
                    "thread": threading.current_thread().name,
                    "site": site,
                    "stack": _short_stack(),
                })
    return (_prev[2] if _prev else _import_sleep)(seconds)


# -- public API -------------------------------------------------------------


def _ours(obj) -> bool:
    return obj in (_DebugLock, _DebugRLock, _ProfileLock, _ProfileRLock,
                   _debug_sleep)


def _apply() -> None:
    """Bring the patched attributes in line with the two flags: the debug
    wrappers, else the profile wrappers, else none of this module's.  An
    attribute another package patched over this module's wrapper is left
    to it."""
    global _prev
    if _installed:
        want = (_DebugLock, _DebugRLock, _debug_sleep)
    elif _prof_installed:
        want = (_ProfileLock, _ProfileRLock, None)
    else:
        want = None
    cur = (threading.Lock, threading.RLock, time.sleep)
    if want is None:
        if _prev is not None:
            for attr, now, before in zip(("Lock", "RLock", "sleep"), cur,
                                         _prev):
                if _ours(now):
                    setattr(time if attr == "sleep" else threading, attr,
                            before)
            _prev = None
        return
    if _prev is None:
        _prev = cur
        on_top = (True, True, True)
    else:
        on_top = tuple(_ours(c) for c in cur)
    for attr, new, top, before in zip(("Lock", "RLock", "sleep"), want,
                                      on_top, _prev):
        if not top:
            continue
        mod = time if attr == "sleep" else threading
        setattr(mod, attr, new if new is not None else before)


def install() -> None:
    """Patch ``threading.Lock``/``RLock`` (locks created from now on are
    instrumented) and ``time.sleep``.  Idempotent.  Supersedes the
    lighter profiler: debug wrappers collect contention stats too."""
    global _installed
    if _installed:
        return
    _installed = True
    _apply()


def uninstall() -> None:
    """Undo ``install`` (already-created wrappers keep working: they
    delegate to the locks they were built over).  Falls back to the
    profile wrappers when the profiler is still on."""
    global _installed
    if not _installed:
        return
    _installed = False
    _apply()


def is_installed() -> bool:
    return _installed


def install_profile() -> None:
    """Patch ``threading.Lock``/``RLock`` with the lightweight
    contention-profiling wrappers (``RAY_TPU_LOCK_PROFILE=1``).
    Idempotent; a no-op patch-wise when the heavier debug mode is
    already active (its wrappers profile too)."""
    global _prof_installed
    if _prof_installed:
        return
    _prof_installed = True
    _apply()


def uninstall_profile() -> None:
    global _prof_installed
    if not _prof_installed:
        return
    _prof_installed = False
    _apply()


def profile_installed() -> bool:
    """True when contention stats are being collected (either mode)."""
    return _prof_installed or _installed


def findings() -> List[Dict[str, Any]]:
    with _state.mu:
        return [dict(f) for f in _state.findings]


def clear() -> None:
    with _state.mu:
        _state.edges.clear()
        _state.findings.clear()
        _state.seen_cycles.clear()
        _state.seen_blocking.clear()
        _state.foreign_released.clear()
    clear_contention()


def clear_contention() -> None:
    """Reset contention stats on every live instrumented lock."""
    with _reg_mu:
        locks = list(_registry)
    for lk in locks:
        lk._stats = _Stats()


def report() -> Dict[str, Any]:
    """Snapshot for the flight recorder's ``lock_findings.json``."""
    with _state.mu:
        return {
            "installed": _installed,
            "pid": os.getpid(),
            "edges": len(_state.edges),
            "findings": [dict(f) for f in _state.findings],
        }


def contention_report(top: int = 20) -> Dict[str, Any]:
    """Aggregate per-creation-site contention stats across every live
    instrumented lock, hottest (by total wait) first.  Snapshot for
    ``format_contention``.

    Waits were only timed on contended acquires: the report backfills
    the untimed zero-wait fast-path acquires into wait bucket 0, so
    ``sum(wait_hist) == acquires``.  Holds were timed on a 1-in-8
    sample (plus all contended holds): ``hold_samples`` is the measured
    count, ``hold_mean_s`` the unbiased-per-sample mean, and
    ``hold_total_s`` the ``mean * acquires`` estimate."""
    with _reg_mu:
        locks = list(_registry)
    agg: Dict[Tuple[str, str], Dict[str, Any]] = {}
    for lk in locks:
        st = lk._stats
        if not st.acquires:
            continue
        row = agg.get((lk.site, lk._kind))
        if row is None:
            row = agg[(lk.site, lk._kind)] = {
                "site": lk.site, "kind": lk._kind, "locks": 0,
                "acquires": 0, "contended": 0,
                "wait_total_s": 0.0, "wait_max_s": 0.0,
                "hold_samples": 0,
                "_hold_measured_s": 0.0, "hold_max_s": 0.0,
                "wait_hist": [0] * (len(_PROF_BOUNDS) + 1),
                "hold_hist": [0] * (len(_PROF_BOUNDS) + 1),
                "_wait_raw": [], "_hold_raw": [],
            }
        row["locks"] += 1
        row["acquires"] += st.acquires
        row["contended"] += st.contended
        row["wait_total_s"] += st.wait_total
        row["wait_max_s"] = max(row["wait_max_s"], st.wait_max)
        row["hold_samples"] += st.hold_samples
        row["_hold_measured_s"] += st.hold_total
        row["hold_max_s"] = max(row["hold_max_s"], st.hold_max)
        for i, v in enumerate(st.wait_hist):
            row["wait_hist"][i] += v
        for i, v in enumerate(st.hold_hist):
            row["hold_hist"][i] += v
        row["_wait_raw"] += st.wait_raw
        row["_hold_raw"] += st.hold_raw
    rows = sorted(agg.values(),
                  key=lambda r: (-r["wait_total_s"], -r["acquires"]))
    for r in rows:
        r["wait_hist"][0] += r["acquires"] - sum(r["wait_hist"])
        r["wait_mean_s"] = r["wait_total_s"] / r["acquires"]
        measured = r.pop("_hold_measured_s")
        samples = r["hold_samples"]
        r["hold_mean_s"] = measured / samples if samples else 0.0
        r["hold_total_s"] = r["hold_mean_s"] * r["acquires"]
        waits = sorted(r.pop("_wait_raw"))
        holds = sorted(r.pop("_hold_raw"))
        # Uncontended acquires waited 0; the kept contended waits stand
        # for every contended one (the latest _RAW_KEEP of them).
        zeros = r["acquires"] - r["contended"]
        r["wait_p50_s"] = _quantile_with_zeros(waits, zeros, r["contended"],
                                               0.5)
        r["wait_p99_s"] = _quantile_with_zeros(waits, zeros, r["contended"],
                                               0.99)
        r["contended_wait_p50_s"] = _quantile(waits, 0.5)
        r["contended_wait_p99_s"] = _quantile(waits, 0.99)
        r["hold_p50_s"] = _quantile(holds, 0.5)
    return {
        "installed": profile_installed(),
        "pid": os.getpid(),
        "bucket_bounds_s": list(_PROF_BOUNDS),
        "total_sites": len(rows),
        "truncated": max(0, len(rows) - top),
        "sites": rows[:top],
    }


def _quantile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank quantile of sorted values (0.0 for none)."""
    if not sorted_vals:
        return 0.0
    k = min(len(sorted_vals) - 1, max(0, int(q * len(sorted_vals) + 0.5)
                                      - 1))
    return sorted_vals[k]


def _quantile_with_zeros(contended: List[float], zeros: int,
                         n_contended: int, q: float) -> float:
    """Quantile over ``zeros`` zero waits and ``n_contended`` waits whose
    distribution ``contended`` (sorted) samples."""
    total = zeros + n_contended
    if not total or not contended:
        return 0.0
    rank = q * total
    if rank <= zeros:
        return 0.0
    return _quantile(contended, (rank - zeros) / n_contended)


def _fmt_s(v: float) -> str:
    if v >= 1.0:
        return f"{v:.2f}s"
    if v >= 1e-3:
        return f"{v * 1e3:.2f}ms"
    if v >= 1e-6:
        return f"{v * 1e6:.1f}us"
    return "0" if v <= 0 else f"{v * 1e9:.0f}ns"


def format_contention(doc: Dict[str, Any]) -> str:
    """Render a ``contention_report()`` document (e.g. a bundle's
    ``lock_contention.json``) as a top-contended-locks table."""
    sites = doc.get("sites") or []
    if not sites:
        return ("no lock contention data "
                "(profiler not installed, or no lock was acquired)")
    lines = [f"lock contention: {doc.get('total_sites', len(sites))} "
             f"site(s), pid {doc.get('pid', '?')} "
             f"(sorted by total wait)",
             f"{'site':<36} {'kind':<5} {'locks':>5} {'acquires':>9} "
             f"{'cont%':>6} {'wait total':>10} {'wait mean':>9} "
             f"{'wait max':>9} {'hold total':>10} {'hold mean':>9} "
             f"{'hold max':>9}"]
    for r in sites:
        acq = r.get("acquires") or 1
        cont = 100.0 * r.get("contended", 0) / acq
        lines.append(
            f"{r.get('site', '?')[-36:]:<36} {r.get('kind', '?'):<5} "
            f"{r.get('locks', 0):>5} {r.get('acquires', 0):>9} "
            f"{cont:>5.1f}% "
            f"{_fmt_s(r.get('wait_total_s', 0.0)):>10} "
            f"{_fmt_s(r.get('wait_mean_s', 0.0)):>9} "
            f"{_fmt_s(r.get('wait_max_s', 0.0)):>9} "
            f"{_fmt_s(r.get('hold_total_s', 0.0)):>10} "
            f"{_fmt_s(r.get('hold_mean_s', 0.0)):>9} "
            f"{_fmt_s(r.get('hold_max_s', 0.0)):>9}")
    if doc.get("truncated"):
        lines.append(f"... {doc['truncated']} more site(s) truncated")
    return "\n".join(lines)
