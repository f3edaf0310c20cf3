"""Serve core (counterpart of ``ray_tpu/serve/api.py``): deployments,
replica actors, the router, handles, and the HTTP ingress.

A deployment's replicas are process actors (``ray_tpu_torch._actor``),
each hosting the user's class (``_ReplicaActor``) with
``max_ongoing_requests`` threads taking its calls.  ``run`` starts them
and hands the deployment to the serve controller
(:mod:`~ray_tpu_torch.serve.controller`), a thread of this process, which
replaces replicas that die, autoscales (``autoscaling_config``) and
publishes versioned replica-set snapshots to the ``_control.py`` store.
Each process that calls a handle (the main process, or a replica calling
another deployment) runs a local ``_Router`` that rebuilds replica handles from
the snapshot and picks by the power of two choices over its own in-flight
counts (reference: pow_2_router.py), from a ``random.Random`` it owns.  It
evicts a replica whose call failed with ``ActorError``, sheds with
``OverloadError`` past the replicas' capacity plus
``max_queued_requests``, and reports its in-flight counts for autoscaling.
A streamed request (``options(stream=True)``) returns a generator of refs,
one per item the replica's generator yields.  Requests for a multiplexed
model (``options(multiplexed_model_id=...)``) prefer replicas that served
the model before and see it through ``get_multiplexed_model_id``.

The class and its constructor arguments travel to the replicas by pickle,
by reference: a module-level class, and module-level functions (or
``functools.partial`` of them) among the arguments.

``run(http_port=...)`` starts the HTTP ingress: ``POST /<deployment>``
with a JSON body answers ``{"result": ...}``; ``"stream": true`` answers
chunked ndjson, one ``{"result": item}`` line per yielded item.
``POST /<deployment>/<method>`` calls that method instead of
``__call__`` (e.g. ``LLMServer.stream``).  It is a
``http.server.ThreadingHTTPServer`` on a daemon thread (JAX's is an
aiohttp app), and ``shutdown()`` stops it.  The gRPC ingress and per-node
proxies raise, naming ROADMAP item 6c.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .. import _actor
from .controller import (METRICS_KV_PREFIX, REPLICA_KV_PREFIX,
                         AutoscalingConfig, ServeController)

#: The ROADMAP entry that brings what this package still refuses.
ITEM_6C = ("ROADMAP Queue 1 item 6c (the gRPC ingress and the per-node "
           "proxies)")

_app_lock = threading.Lock()
#: The deployments this process runs (its controller reconciles them).
_deployments: Dict[str, "_DeploymentState"] = {}
_routers: Dict[str, "_Router"] = {}
_controller: Optional[ServeController] = None
_http_server: Optional["_HttpServer"] = None


class OverloadError(RuntimeError):
    """A request was shed by admission control (deployment queue bound or
    SLO router).  Retriable: the service is healthy but saturated; back off
    and resend instead of treating it as a failure."""

    retriable = True


@dataclass
class Deployment:
    cls_or_fn: Any
    name: str
    num_replicas: int = 1
    max_ongoing_requests: int = 8
    num_cpus: float = 0.0
    num_tpus: int = 0
    ray_actor_options: Dict[str, Any] = field(default_factory=dict)
    init_args: tuple = ()
    init_kwargs: Dict[str, Any] = field(default_factory=dict)
    # Queue-depth autoscaling (reference: serve/autoscaling_policy.py);
    # None = fixed num_replicas.
    autoscaling_config: Optional[AutoscalingConfig] = None
    # Admission bound on the handle path: reject (OverloadError) once
    # in-flight requests reach replica capacity (num_replicas *
    # max_ongoing_requests) plus this queue allowance.  None = queue
    # unboundedly.
    max_queued_requests: Optional[int] = None

    def __post_init__(self):
        _check_autoscaling(self.autoscaling_config)

    def options(self, **kw) -> "Deployment":
        known = {f.name for f in dataclasses.fields(Deployment)}
        return dataclasses.replace(
            self, **{k: v for k, v in kw.items() if k in known})

    def bind(self, *args, **kwargs) -> "Application":
        return Application(dataclasses.replace(self, init_args=args,
                                               init_kwargs=kwargs))


@dataclass
class Application:
    deployment: Deployment


def _check_autoscaling(cfg) -> None:
    if cfg is not None and not isinstance(cfg, AutoscalingConfig):
        raise TypeError(f"autoscaling_config must be a serve."
                        f"AutoscalingConfig, not {type(cfg).__name__}")


def deployment(_cls=None, *, name: Optional[str] = None,
               num_replicas: int = 1, max_ongoing_requests: int = 8,
               num_cpus: float = 0.0, num_tpus: int = 0,
               ray_actor_options: Optional[Dict[str, Any]] = None,
               autoscaling_config: Optional[AutoscalingConfig] = None,
               max_queued_requests: Optional[int] = None):
    """``@serve.deployment`` (reference: serve/api.py:471)."""
    def wrap(cls):
        return Deployment(cls, name or cls.__name__,
                          num_replicas=num_replicas,
                          max_ongoing_requests=max_ongoing_requests,
                          num_cpus=num_cpus, num_tpus=num_tpus,
                          ray_actor_options=ray_actor_options or {},
                          autoscaling_config=autoscaling_config,
                          max_queued_requests=max_queued_requests)
    if _cls is not None:
        return wrap(_cls)
    return wrap


class _ReplicaActor:
    """Hosts the user callable (reference: replica.py
    UserCallableWrapper)."""

    def __init__(self, target, init_args, init_kwargs):
        if isinstance(target, type):
            self._callable = target(*init_args, **init_kwargs)
        else:
            self._callable = target

    def _resolve_target(self, method: str):
        target = getattr(self._callable, method, None)
        if target is None and method == "__call__":
            target = self._callable
        if target is None:
            raise AttributeError(f"deployment has no method {method!r}")
        return target

    def handle_request(self, method: str, args, kwargs,
                       multiplexed_model_id: Optional[str] = None):
        target = self._resolve_target(method)
        if multiplexed_model_id is None:
            return target(*args, **kwargs)
        # Multiplexed request: expose the model id for the duration of the
        # call (reference: serve.get_multiplexed_model_id()).
        from .multiplex import _current_model_id, _set_current_model_id
        token = _set_current_model_id(multiplexed_model_id)
        try:
            return target(*args, **kwargs)
        finally:
            _current_model_id.reset(token)

    def handle_request_stream(self, method: str, args, kwargs,
                              multiplexed_model_id: Optional[str] = None):
        """Generator entry point: runs as a streaming actor call, each
        yielded item sent as it is made (token streaming).  It IS a
        generator, so the multiplexed model id stays set while the body
        runs."""
        target = self._resolve_target(method)
        if multiplexed_model_id is None:
            yield from target(*args, **kwargs)
            return
        from .multiplex import _current_model_id, _set_current_model_id
        token = _set_current_model_id(multiplexed_model_id)
        try:
            yield from target(*args, **kwargs)
        finally:
            _current_model_id.reset(token)

    def ping(self):
        return "ok"

    def shutdown(self) -> bool:
        """Replica teardown: the callable's own ``shutdown`` where it has
        one (``LLMServer`` joins its drive thread)."""
        close = getattr(self._callable, "shutdown", None)
        if callable(close):
            close()
        return True


def _multiplex_cap(target) -> int:
    """The replica LRU size of a class's ``@serve.multiplexed`` loader
    (8 without one), shipped to routers in the snapshot so they stop
    preferring a replica once it would have evicted the model."""
    from .multiplex import _MultiplexedDescriptor
    if isinstance(target, type):
        for klass in target.__mro__:  # loaders may be inherited
            for attr in vars(klass).values():
                if isinstance(attr, _MultiplexedDescriptor):
                    return attr._max
    return 8


class _DeploymentState:
    """Replica set of one deployment; mutated by start/stop and the
    controller's reconcile loop (self-healing + autoscaling)."""

    #: Seconds a new replica may take to build its callable.
    START_TIMEOUT_S = 600.0

    def __init__(self, dep: Deployment):
        self.deployment = dep
        self.replicas: List[Any] = []
        self.stopped = False
        # Reconcile-backfill crash-loop backoff (controller-owned).
        self.backfill_not_before = 0.0
        self.backfill_backoff_s = 0.5
        ac = dep.autoscaling_config
        self.target_replicas = max(dep.num_replicas, ac.min_replicas) \
            if ac is not None else dep.num_replicas
        self.multiplex_cap = _multiplex_cap(dep.cls_or_fn)
        self._version = 0
        self._lock = threading.Lock()

    def _actor_class(self):
        opts: Dict[str, Any] = {
            "max_concurrency": self.deployment.max_ongoing_requests,
            "num_cpus": self.deployment.num_cpus}
        opts.update(self.deployment.ray_actor_options)
        return _actor.remote(_ReplicaActor).options(**opts)

    def _spawn(self):
        dep = self.deployment
        return self._actor_class().remote(dep.cls_or_fn, dep.init_args,
                                          dep.init_kwargs)

    def add_replica(self, wait_ready: bool = False):
        # Safe bare read: stopped is a monotonic shutdown latch; a stale
        # False only delays the error to the actor-create round trip.
        if self.stopped:  # ray-tpu: noqa[RT401]
            raise RuntimeError("deployment is stopped")
        r = self._spawn()
        if wait_ready:
            try:
                _actor.get(r.ping.remote(), timeout=self.START_TIMEOUT_S)
            except BaseException:
                _actor.kill(r)
                raise
        with self._lock:
            if self.stopped:
                _actor.kill(r)
                raise RuntimeError("deployment is stopped")
            self.replicas.append(r)
        return r

    def pop_replica(self, min_load: Optional[Dict[str, int]] = None):
        """Detach and return the least-loaded replica (by the routers'
        reported loads) WITHOUT killing it: the controller drains it
        first."""
        with self._lock:
            if not self.replicas:
                return None
            loads = min_load or {}
            idx = min(range(len(self.replicas)),
                      key=lambda i: loads.get(self.replicas[i]._actor_id, 0))
            return self.replicas.pop(idx)

    def start(self) -> None:
        """Start the target's replicas together and wait until each has
        built its callable."""
        replicas = [self._spawn() for _ in range(self.target_replicas)]
        with self._lock:
            self.replicas = replicas
        try:
            _actor.get([r.ping.remote() for r in replicas],
                       timeout=self.START_TIMEOUT_S)
        except BaseException:
            self.stop()
            raise

    def stop(self) -> None:
        with self._lock:
            self.stopped = True
            replicas, self.replicas = self.replicas, []
        shut = [r.shutdown.remote() for r in replicas]
        try:
            _actor.wait(shut, num_returns=len(shut), timeout=10)
        finally:
            for r in replicas:
                _actor.kill(r)


def _state(name: str) -> "_DeploymentState":
    """The state of a deployment this process runs."""
    with _app_lock:
        state = _deployments.get(name)
    if state is None:
        raise ValueError(f"no deployment named {name!r}")
    return state


class _Router:
    """Per-process replica-set cache + power-of-two-choices routing over
    THIS router's in-flight counts (reference: pow_2_router.py: routers
    track their own counts; the controller sums the reports for
    autoscaling)."""

    REFRESH_S = 1.0
    #: Seconds between reports of a router outside the controller's
    #: process.
    REPORT_S = 0.5

    def __init__(self, name: str):
        self.name = name
        self.router_id = os.urandom(8).hex()
        self.rng = random.Random()
        self._lock = threading.Lock()
        self._version = -1
        self._replicas: List[Tuple[str, Any]] = []  # (actor id, handle)
        self._inflight: Dict[str, int] = {}
        self._fetched = 0.0
        self._known = False
        # Admission state from the snapshot: total replica capacity (sum
        # of max_ongoing) and the deployment's queue allowance (None =
        # unbounded).
        self._capacity = 0
        self._max_queued: Optional[int] = None
        from .multiplex import RouterAffinity
        self.affinity = RouterAffinity(8)
        self._reporter_started = False

    def evict(self, actor_id: str) -> None:
        with self._lock:
            before = len(self._replicas)
            self._replicas = [e for e in self._replicas if e[0] != actor_id]
            if len(self._replicas) != before:
                self._inflight.pop(actor_id, None)
                self.affinity.drop_replica(actor_id)
                # Force the next pick to consult the snapshot.
                self._fetched = 0.0

    def refresh(self, force: bool = False) -> bool:
        """Re-read the snapshot (at most once a ``REFRESH_S`` unless
        forced); False when the deployment has none."""
        now = time.monotonic()
        with self._lock:
            if not force and now - self._fetched < self.REFRESH_S:
                return self._known
        blob = _actor._plane().kv_get(REPLICA_KV_PREFIX + self.name)
        with self._lock:
            self._fetched = now
            self._known = blob is not None
            if blob is None:
                self._replicas = []
                return False
            version, entries, cap, max_queued = pickle.loads(blob)
            if version == self._version:
                return True
            self._version = version
            self._capacity = sum(e[2] for e in entries)
            self._max_queued = max_queued
            if cap != self.affinity._max:
                from .multiplex import RouterAffinity
                self.affinity = RouterAffinity(cap)
            self._replicas = [
                (aid, _actor.ActorHandle(aid, cls_name, max_ongoing))
                for aid, cls_name, max_ongoing in entries]
            live = {aid for aid, _ in self._replicas}
            for gone in set(self._inflight) - live:
                self._inflight.pop(gone, None)
                self.affinity.drop_replica(gone)
            return True

    def pick(self, model_id: Optional[str]) -> Optional[Tuple[str, Any]]:
        with self._lock:
            n = len(self._replicas)
            if n == 0:
                return None
            if model_id is not None and n > 1:
                affine = set(self.affinity.replicas_for(model_id))
                cands = [e for e in self._replicas if e[0] in affine]
                if cands:
                    return min(cands, key=lambda e:
                               self._inflight.get(e[0], 0))
            if n == 1:
                return self._replicas[0]
            ia, ib = self.rng.sample(range(n), 2)
            a, b = self._replicas[ia], self._replicas[ib]
            return a if self._inflight.get(a[0], 0) <= \
                self._inflight.get(b[0], 0) else b

    def note_start(self, actor_id: str) -> None:
        with self._lock:
            self._inflight[actor_id] = self._inflight.get(actor_id, 0) + 1
            self._set_ongoing_gauge()
        self._ensure_reporter()

    def note_done(self, actor_id: str) -> None:
        with self._lock:
            if actor_id in self._inflight:
                self._inflight[actor_id] = max(
                    0, self._inflight[actor_id] - 1)
            self._set_ongoing_gauge()

    def _set_ongoing_gauge(self) -> None:
        """Under ``self._lock``."""
        from ..util import telemetry
        telemetry.set_gauge("ray_tpu_serve_ongoing_requests",
                            sum(self._inflight.values()),
                            tags={"deployment": self.name})

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return {k: v for k, v in self._inflight.items() if v}

    def over_admission_bound(self) -> bool:
        """True when this router's in-flight count reaches replica
        capacity plus the deployment's max_queued_requests allowance."""
        with self._lock:
            if self._max_queued is None or not self._replicas:
                return False
            return sum(self._inflight.values()) >= \
                self._capacity + self._max_queued

    def _ensure_reporter(self) -> None:
        """Outside the controller's process, report the in-flight counts
        to the store every ``REPORT_S`` (the controller's own process
        reads this router directly)."""
        with _app_lock:
            if _controller is not None:
                return
        with self._lock:
            if self._reporter_started:
                return
            self._reporter_started = True
        from .. import _sanitizer
        _sanitizer.spawn(self._report_loop,
                         name=f"serve-metrics-{self.name}")

    def _report_loop(self) -> None:
        key = f"{METRICS_KV_PREFIX}{self.name}/{self.router_id}"
        last = None
        while True:
            time.sleep(self.REPORT_S)
            with _app_lock:
                if _routers.get(self.name) is not self:
                    return  # replaced (redeploy): retire
            counts = self.counts()
            if counts or counts != last:
                try:
                    # CLOCK_MONOTONIC is one clock for every process of
                    # the host, which is all the port's session spans.
                    _actor._plane().kv_put(key, pickle.dumps(
                        (time.monotonic(), counts)))
                except OSError:
                    return  # the store's server is gone
                last = counts


def _router_for(name: str) -> _Router:
    with _app_lock:
        r = _routers.get(name)
        if r is None:
            r = _routers[name] = _Router(name)
    return r


def _local_router_counts(name: str) -> Optional[Tuple[str, Dict[str, int]]]:
    """(router id, in-flight counts) of this process's router for
    ``name``, if it has one (read by the controller)."""
    with _app_lock:
        r = _routers.get(name)
    return None if r is None else (r.router_id, r.counts())


class DeploymentHandle:
    """reference: serve/handle.py:1041 — ``.remote()`` routes a request;
    ``options(stream=True)`` returns a generator of refs over a generator
    method's yielded items (token streaming).  It pickles: a handle sent
    to another process reaching the same store routes from there."""

    def __init__(self, name: str, method: str = "__call__",
                 multiplexed_model_id: Optional[str] = None,
                 stream: bool = False):
        self._name = name
        self._method = method
        self._model_id = multiplexed_model_id
        self._stream = stream

    def options(self, method_name: Optional[str] = None,
                multiplexed_model_id: Optional[str] = None,
                stream: Optional[bool] = None) -> "DeploymentHandle":
        return DeploymentHandle(self._name, method_name or self._method,
                                multiplexed_model_id or self._model_id,
                                self._stream if stream is None else stream)

    def __getattr__(self, item):
        if item.startswith("_"):
            raise AttributeError(item)
        return DeploymentHandle(self._name, item, self._model_id,
                                self._stream)

    def remote(self, *args, **kwargs):
        from ..util import telemetry
        t_route = time.perf_counter()
        tags = {"deployment": self._name}
        router = _router_for(self._name)
        if not router.refresh():
            telemetry.inc("ray_tpu_serve_request_errors_total", tags=tags)
            raise ValueError(f"no deployment named {self._name!r}")
        if router.over_admission_bound():
            # Overload degrades into a fast retriable rejection, not a
            # queue that times out later.
            telemetry.inc("ray_tpu_serve_shed_total", tags=tags)
            raise OverloadError(
                f"deployment {self._name!r} is over its admission bound "
                "(max_queued_requests); retry with backoff")
        # A reconcile may briefly leave zero replicas (all died at once):
        # wait for the controller to backfill rather than failing.
        deadline = time.monotonic() + 60
        while True:
            picked = router.pick(self._model_id)
            if picked is not None:
                break
            if time.monotonic() > deadline:
                telemetry.inc("ray_tpu_serve_request_errors_total",
                              tags=tags)
                raise RuntimeError(
                    f"deployment {self._name!r} has no live replicas")
            time.sleep(0.05)
            router.refresh(force=True)
        actor_id, replica = picked
        telemetry.inc("ray_tpu_serve_requests_total", tags=tags)
        router.note_start(actor_id)
        if self._model_id is not None:
            router.affinity.note(actor_id, self._model_id)
        extra = {} if self._model_id is None \
            else {"multiplexed_model_id": self._model_id}

        def finished(exc: Optional[BaseException]) -> None:
            router.note_done(actor_id)
            if isinstance(exc, _actor.ActorError):
                router.evict(actor_id)
            telemetry.observe("ray_tpu_serve_request_latency_seconds",
                              time.perf_counter() - t_route, tags=tags)

        if self._stream:
            gen = replica.handle_request_stream.options(
                num_returns="streaming").remote(self._method, args, kwargs,
                                                **extra)

            def stream_refs():
                exc = None
                try:
                    for ref in gen:
                        err = ref.future().exception()
                        if err is not None:
                            exc = err
                        yield ref
                finally:
                    finished(exc)
            return stream_refs()
        ref = replica.handle_request.remote(self._method, args, kwargs,
                                            **extra)
        ref.future().add_done_callback(lambda f: finished(f.exception()))
        return ref


def _ensure_controller() -> ServeController:
    global _controller
    with _app_lock:
        if _controller is None:
            # Session-lifetime by design: deployments keep serving after
            # the driver's handles are gone — declare it to the leak
            # sanitizer.
            from .. import _sanitizer
            from .controller import CONTROLLER_NAME
            _sanitizer.session_scoped(CONTROLLER_NAME)
            _controller = ServeController(_deployments, _app_lock)
        return _controller


def run(app: Application, *, name: Optional[str] = None,
        route_prefix: Optional[str] = None,
        http_port: Optional[int] = None) -> DeploymentHandle:
    """Start the deployment's replicas, hand it to this process's
    controller and return a handle (reference: serve/api.py:902).  A
    deployment of the same name is replaced.  ``http_port`` starts the
    HTTP ingress on it (0: a free port, ``serve.api.http_address()``)."""
    dep = app.deployment if isinstance(app, Application) else app
    if dep.num_tpus > 1:
        raise NotImplementedError(
            f"num_tpus={dep.num_tpus}: a replica holds one card (its "
            f"ray_actor_options 'device'); more per replica is not ported")
    ctrl = _ensure_controller()
    state = _DeploymentState(dep)
    with _app_lock:
        old = _deployments.pop(dep.name, None)
    if old is not None:
        old.stop()
    state.start()
    with _app_lock:
        _deployments[dep.name] = state
        _routers.pop(dep.name, None)  # drop the stale replica cache
    ctrl._publish(state)
    if http_port is not None:
        _ensure_http(http_port)
    return DeploymentHandle(dep.name)


def get_deployment_handle(name: str) -> DeploymentHandle:
    if _actor._plane().kv_get(REPLICA_KV_PREFIX + name) is None:
        raise ValueError(f"no deployment named {name!r}")
    return DeploymentHandle(name)


def status() -> Dict[str, Dict[str, Any]]:
    """The deployments this process runs: replicas, target, and the
    routers' in-flight counts by replica."""
    with _app_lock:
        states = list(_deployments.items())
        ctrl = _controller
    out = {}
    for name, s in states:
        with s._lock:
            n = len(s.replicas)
        out[name] = {"num_replicas": n, "target_replicas": s.target_replicas,
                     "inflight": ctrl._replica_loads(s) if ctrl else {}}
    return out


def shutdown() -> None:
    """Stop the controller, every deployment (its replicas' ``shutdown``,
    then kill) and the HTTP ingress."""
    global _controller, _http_server
    with _app_lock:
        ctrl, _controller = _controller, None
        states = dict(_deployments)
        _deployments.clear()
        _routers.clear()
        server, _http_server = _http_server, None
    if ctrl is not None:
        ctrl.stop()
    for name, s in states.items():
        s.stop()
        ServeController.clear(name)
    if server is not None:
        server.stop()


# --------------------------------------------------------------------- #
# HTTP ingress (reference: _private/proxy.py; the standard library's
# threading server instead of uvicorn)
# --------------------------------------------------------------------- #

def _ingress_handler():
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        """POST /<deployment>[/<method>]: the JSON body through the
        deployment's handle (chunked ndjson when ``stream`` is set)."""

        protocol_version = "HTTP/1.1"

        def log_message(self, *_args):
            pass

        def _send(self, code: int, body: bytes,
                  ctype: str = "application/json") -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj) -> None:
            self._send(code, json.dumps(obj).encode())

        def _chunk(self, data: bytes) -> None:
            self.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))
            self.wfile.flush()

        def do_GET(self):
            if self.path == "/-/healthz":
                self._send(200, b"ok", "text/plain")
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            from ..util import telemetry
            name, _, method = self.path.split("?")[0].strip("/") \
                .partition("/")
            n = int(self.headers.get("Content-Length") or 0)
            try:
                body = json.loads(self.rfile.read(n) or b"{}")
            except ValueError:
                body = {}
            stream = bool(body.pop("stream", False)) \
                if isinstance(body, dict) else False
            try:
                handle = get_deployment_handle(name)
                if method:
                    handle = handle.options(method_name=method)
            except Exception as e:  # noqa: BLE001 - back to the client
                telemetry.inc("ray_tpu_serve_request_errors_total",
                              tags={"deployment": name})
                return self._json(500, {"error": repr(e)})
            if stream:
                return self._stream(handle, body)
            try:
                ref = handle.remote(body)
            except Exception as e:  # noqa: BLE001 - remote() counted it
                return self._json(500, {"error": repr(e)})
            try:
                result = _actor.get(ref, timeout=300)
                payload = json.dumps({"result": result}).encode()
            except Exception as e:  # noqa: BLE001 - back to the client
                telemetry.inc("ray_tpu_serve_request_errors_total",
                              tags={"deployment": name})
                return self._json(500, {"error": repr(e)})
            self._send(200, payload)

        def _stream(self, handle, body) -> None:
            """Chunked streaming (reference: proxy.py streaming
            responses): each yielded item is one ndjson chunk; a failure
            mid-stream is an error chunk, never a second response."""
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            try:
                for ref in handle.options(stream=True).remote(body):
                    item = _actor.get(ref, timeout=300)
                    self._chunk((json.dumps({"result": item})
                                 + "\n").encode())
            except Exception as e:  # noqa: BLE001 - an error chunk
                self._chunk((json.dumps({"error": repr(e)})
                             + "\n").encode())
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()

    return Handler


class _HttpServer:
    def __init__(self, port: int, host: str = "127.0.0.1"):
        from http.server import ThreadingHTTPServer
        self._server = ThreadingHTTPServer((host, port), _ingress_handler())
        self._server.daemon_threads = True
        self.host, self.port = self._server.server_address[:2]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="serve-http", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=10)


def _ensure_http(port: int) -> None:
    global _http_server
    with _app_lock:
        if _http_server is None:
            _http_server = _HttpServer(port)


def http_address() -> Optional[Tuple[str, int]]:
    """(host, port) of this process's HTTP ingress, or None."""
    with _app_lock:
        s = _http_server
    return None if s is None else (s.host, s.port)


def add_grpc_service(*_args, **_kwargs):
    """The gRPC ingress (JAX: ``serve.add_grpc_service``) is not
    ported."""
    raise NotImplementedError(f"the gRPC ingress is not ported yet: "
                              f"{ITEM_6C}")


def remove_grpc_service(*_args, **_kwargs):
    """The gRPC ingress (JAX: ``serve.remove_grpc_service``) is not
    ported."""
    raise NotImplementedError(f"the gRPC ingress is not ported yet: "
                              f"{ITEM_6C}")
