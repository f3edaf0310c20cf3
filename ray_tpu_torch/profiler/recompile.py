"""Recompile detector: per-site accounting of kernel builds and first
launches, and shape-churn warnings (counterpart of
ray_tpu/profiler/recompile.py).

The port compiles nothing per call: its kernels are CUDA libraries built
once by ``nvcc`` and launched by shape.  What stands in for an XLA
compile is one of two events, each reported through
``ops._build.compile_listener``:

* ``build`` — a kernel library built or loaded (``ops/_build.function``'s
  first use of a library in this process: ``nvcc`` where its hash is not
  built yet, then ``dlopen``);
* ``launch`` — the first launch of a new launch key: a miss in
  ``ops/paged_attention._LAUNCH`` (the prepared launch of one (device,
  stream, dtype, B, H, Hkv, D, P, page size)).  The flash kernels keep no
  per-shape setup, so their launches never count.

Each event is charged to the site that :func:`track` has active in the
calling thread (a call on another thread — an engine's drive thread — is
charged to the site active there, if any):

* :func:`track` wraps a callable; every event that fires while the
  wrapped call runs is charged to the site's telemetry series
  (``ray_tpu_profiler_compile_total`` / ``_seconds{fn}``).
* A site is **warm** once a call completes with no event (steady state).
  An event AFTER that with an argument signature not seen before is a
  post-warmup recompilation: ``ray_tpu_profiler_recompiles_total`` is
  bumped and a once-per-site warning names the argument shapes/dtypes
  that changed — the culprit, not just the symptom.
* :func:`install` turns the listener on process-wide.  There is no
  ``jax.jit`` to patch: where JAX's install tracks every jitted function,
  the port's step factory tracks its own step while the detector is on
  (``parallel.make_lm_train_step``'s step is site ``lm_train_step``,
  through :func:`track_if_installed`), and any other callable is a site
  once passed to :func:`track`.  The port's train workers install it by
  default (``RAY_TPU_RECOMPILE_DETECT=0`` opts out), so the first kernel
  builds of a worker's train step are charged to ``lm_train_step``.

With no listener installed, the hooks in ``_build``/``paged_attention``
are one module-level check on their miss paths; a launch that hits its
cache pays nothing.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Dict, List, Optional

from ..util import telemetry

logger = logging.getLogger("ray_tpu_torch.profiler")

_lock = threading.Lock()
_enabled = False

#: site name -> _SiteState
_sites: Dict[str, "_SiteState"] = {}

_tls = threading.local()


class _SiteState:
    __slots__ = ("name", "signatures", "compiles", "compile_s", "warm",
                 "recompiles", "warned", "last_signature", "events")

    def __init__(self, name: str):
        self.name = name
        self.signatures: List[str] = []
        self.compiles = 0
        self.compile_s = 0.0
        self.warm = False
        self.recompiles = 0
        self.warned = False
        self.last_signature: Optional[str] = None
        #: "build:<library>" / "launch:<kernel>" of every event charged.
        self.events: List[str] = []


def _on_compile(kind: str, what: str, seconds: float) -> None:
    """``ops._build.compile_listener``: charge one build or first launch
    to whichever tracked site is executing on this thread."""
    if not _enabled:
        return
    frame = getattr(_tls, "site", None)
    if frame is None:
        return
    frame["compiles"] += 1
    frame["compile_s"] += seconds
    frame["events"].append(f"{kind}:{what}")


def _ensure_listener() -> bool:
    from ..ops import _build
    _build.compile_listener = _on_compile
    return True


def _leaves(x: Any) -> list:
    """Leaves of a tree as JAX flattens one: dict values by sorted key,
    list and tuple items, None an empty tree."""
    if x is None:
        return []
    if isinstance(x, dict):
        return [leaf for k in sorted(x) for leaf in _leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [leaf for v in x for leaf in _leaves(v)]
    return [x]


def _signature(args: tuple, kwargs: dict, static_argnums: tuple = (),
               static_argnames: tuple = ()) -> str:
    """Compact shape/dtype signature of a call's arguments (JAX's, with
    torch dtypes named as numpy's: ``float32[2,3]``).  The arguments
    named static are rendered by VALUE in a ``static(...)`` suffix, as
    JAX renders ``jax.jit``'s; tracked sites name none.  Only computed
    when an event fired (never on the per-step hot path)."""
    def leaf(x: Any) -> str:
        shape = getattr(x, "shape", None)
        dtype = getattr(x, "dtype", None)
        if shape is not None and dtype is not None:
            name = str(dtype).replace("torch.", "")
            return f"{name}[{','.join(str(d) for d in shape)}]"
        if isinstance(x, (bool, int, float, complex, str, bytes,
                          type(None))):
            return f"{type(x).__name__}={x!r}"
        return type(x).__name__

    parts: List[str] = []
    static: List[str] = []
    for i, a in enumerate(args):
        if i in static_argnums:
            static.append(f"[{i}]={a!r}")
        else:
            parts.extend(leaf(x) for x in _leaves(a))
    for k in sorted(kwargs):
        if k in static_argnames:
            static.append(f"{k}={kwargs[k]!r}")
        else:
            parts.extend(leaf(x) for x in _leaves(kwargs[k]))
    if len(parts) > 64:
        parts = parts[:64] + [f"...(+{len(parts) - 64} leaves)"]
    sig = "(" + ", ".join(parts) + ")"
    if static:
        sig += " static(" + ", ".join(static) + ")"
    return sig


class TrackedFunction:
    """Transparent wrapper around a callable: forwards every attribute to
    the wrapped function."""

    def __init__(self, fn, site: str):
        self.__wrapped__ = fn
        self._site = _site_state(site)

    def __getattr__(self, name: str):
        if name == "__wrapped__":
            # Instance dict not populated yet (unpickle path): avoid
            # recursing through this very lookup.
            raise AttributeError(name)
        return getattr(self.__wrapped__, name)

    def __call__(self, *args, **kwargs):
        if not _enabled:
            return self.__wrapped__(*args, **kwargs)
        frame = {"compiles": 0, "compile_s": 0.0, "events": []}
        prev = getattr(_tls, "site", None)
        _tls.site = frame
        try:
            return self.__wrapped__(*args, **kwargs)
        finally:
            # Nested tracked calls shadow this frame while they run, so
            # their events are charged to the INNER site only.
            _tls.site = prev
            if frame["compiles"]:
                self._note_compiles(frame, args, kwargs)
            else:
                self._site.warm = True

    def _note_compiles(self, frame: Dict[str, Any], args, kwargs) -> None:
        site = self._site
        tags = {"fn": site.name}
        telemetry.inc("ray_tpu_profiler_compile_total",
                      frame["compiles"], tags=tags)
        telemetry.observe("ray_tpu_profiler_compile_seconds",
                          frame["compile_s"], tags=tags)
        sig = _signature(args, kwargs)
        with _lock:
            site.compiles += frame["compiles"]
            site.compile_s += frame["compile_s"]
            site.events += frame["events"]
            known = sig in site.signatures
            if not known:
                site.signatures.append(sig)
            site.last_signature = sig
            post_warmup = site.warm and not known
            if post_warmup:
                site.recompiles += 1
                warn_now = not site.warned
                site.warned = True
            else:
                warn_now = False
            prior = [s for s in site.signatures if s != sig]
        if post_warmup:
            telemetry.inc("ray_tpu_profiler_recompiles_total", tags=tags)
            what = ", ".join(frame["events"])
            if warn_now:
                logger.warning(
                    "post-warmup kernel build/first launch in %r (%s, "
                    "%.3fs): argument shapes/dtypes changed to %s "
                    "(previously seen: %s).  Pad or bucket the varying "
                    "dimension — every distinct shape prepares its own "
                    "launch.  (warned once per site; "
                    "ray_tpu_profiler_recompiles_total{fn=%r} keeps "
                    "counting)",
                    site.name, what, frame["compile_s"], sig,
                    "; ".join(prior[-3:]) or "<none recorded>", site.name)


def _site_state(name: str) -> _SiteState:
    with _lock:
        st = _sites.get(name)
        if st is None:
            st = _sites[name] = _SiteState(name)
        return st


def track(fn, name: Optional[str] = None):
    """Wrap ``fn`` with per-site accounting of kernel builds and first
    launches, and post-warmup detection; turns the detector on."""
    if isinstance(fn, TrackedFunction):
        return fn
    site = name or getattr(fn, "__name__", None) or type(fn).__name__
    global _enabled
    _enabled = True
    _ensure_listener()
    return TrackedFunction(fn, site)


def track_if_installed(fn, name: str):
    """``fn`` tracked as site ``name`` while the detector is on, else
    ``fn`` itself (no wrapper where nothing listens)."""
    return TrackedFunction(fn, name) if _enabled else fn


def install() -> bool:
    """Enable the detector process-wide (the listener in ``ops._build``).
    There is no ``jax.jit`` to patch: sites are what :func:`track` wraps.
    Safe to call repeatedly."""
    global _enabled
    _enabled = True
    return _ensure_listener()


def uninstall() -> None:
    """Disable the detector and take the listener out of ``ops._build``
    (the hooks are back to one ``None`` check)."""
    global _enabled
    _enabled = False
    from ..ops import _build
    if _build.compile_listener is _on_compile:
        _build.compile_listener = None


def report() -> Dict[str, Any]:
    """Per-site accounting snapshot (diagnostics / tests)."""
    with _lock:
        return {name: {
            "compiles": st.compiles,
            "compile_seconds": round(st.compile_s, 4),
            "warm": st.warm,
            "recompiles": st.recompiles,
            "signatures": list(st.signatures),
            "last_signature": st.last_signature,
            "events": list(st.events),
        } for name, st in _sites.items()}


def _reset_for_tests() -> None:
    global _enabled
    with _lock:
        _sites.clear()
    uninstall()
    _enabled = False
