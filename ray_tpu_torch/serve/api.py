"""Serve core (counterpart of ``ray_tpu/serve/api.py``): deployments,
replica actors, the handle's router, and ``run``/``status``/``shutdown``.

A deployment's replicas are process actors (``ray_tpu_torch._actor``),
each hosting the user's class (``_ReplicaActor``), with
``max_ongoing_requests`` threads taking its calls.  The port keeps the
serve controller in the calling process: ``run`` starts the replicas and
records the deployment there, and ``DeploymentHandle.remote`` routes each
request to the replica with the fewest requests in flight (JAX: the power
of two choices over the same counts; with one or two replicas the same
pick), shedding with ``OverloadError`` once the in-flight count reaches the
replicas' capacity plus ``max_queued_requests``.  A streamed request
(``options(stream=True)``) returns a generator of refs, one per item the
replica's generator yields.

The class and its constructor arguments travel to the replicas by pickle,
by reference: a module-level class, and module-level functions (or
``functools.partial`` of them) among the arguments.

Not ported yet (each raises ``NotImplementedError`` naming ROADMAP Queue 1
item 6b, the process tier's part 2): ``autoscaling_config``, model
multiplexing, and the HTTP/gRPC ingress (``run(http_port=...)``).  The
in-process controller does not restart a replica that dies: its requests
fail with ``ActorError``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .. import _actor

#: The ROADMAP entry that brings what this module refuses.
PART_2 = ("ROADMAP Queue 1 item 6b (the process tier, part 2: serve "
          "autoscaling and replica recovery, ingress, the cross-process KV "
          "handoff, RemoteReplica, the four-card fleet)")

_app_lock = threading.Lock()
_deployments: Dict[str, "_DeploymentState"] = {}


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
    autoscaling_config: Any = None
    # Admission bound on the handle path: reject (OverloadError) once
    # in-flight requests reach replica capacity (num_replicas *
    # max_ongoing_requests) plus this queue allowance.  None = queue
    # unboundedly.
    max_queued_requests: Optional[int] = None

    def options(self, **kw) -> "Deployment":
        _refuse_autoscaling(kw.get("autoscaling_config"))
        known = {f.name for f in dataclasses.fields(Deployment)}
        return dataclasses.replace(
            self, **{k: v for k, v in kw.items() if k in known})

    def bind(self, *args, **kwargs) -> "Application":
        return Application(dataclasses.replace(self, init_args=args,
                                               init_kwargs=kwargs))


@dataclass
class Application:
    deployment: Deployment


def _refuse_autoscaling(autoscaling_config) -> None:
    if autoscaling_config is not None:
        raise NotImplementedError(
            f"autoscaling_config is not ported yet: {PART_2}")


def deployment(_cls=None, *, name: Optional[str] = None,
               num_replicas: int = 1, max_ongoing_requests: int = 8,
               num_cpus: float = 0.0, num_tpus: int = 0,
               ray_actor_options: Optional[Dict[str, Any]] = None,
               autoscaling_config=None,
               max_queued_requests: Optional[int] = None):
    """``@serve.deployment`` (reference: serve/api.py:471)."""
    _refuse_autoscaling(autoscaling_config)

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

    def handle_request(self, method: str, args, kwargs):
        return self._resolve_target(method)(*args, **kwargs)

    def handle_request_stream(self, method: str, args, kwargs):
        """Generator entry point: runs as a streaming actor call, each
        yielded item sent as it is made (token streaming)."""
        yield from self._resolve_target(method)(*args, **kwargs)

    def ping(self):
        return "ok"

    def shutdown(self) -> bool:
        """Replica teardown: the callable's own ``shutdown`` where it has
        one (``LLMServer`` joins its drive thread)."""
        close = getattr(self._callable, "shutdown", None)
        if callable(close):
            close()
        return True


class _DeploymentState:
    """One deployment's replica set and its router state: the in-flight
    count of each replica, the capacity and the queue allowance."""

    def __init__(self, dep: Deployment):
        self.deployment = dep
        self.replicas: List[Any] = []
        self.inflight: Dict[Any, int] = {}
        self._lock = threading.Lock()

    def _replica_opts(self) -> Dict[str, Any]:
        opts: Dict[str, Any] = {
            "max_concurrency": self.deployment.max_ongoing_requests,
            "num_cpus": self.deployment.num_cpus}
        opts.update(self.deployment.ray_actor_options)
        return opts

    def start(self, timeout: float = 600.0) -> None:
        """Start every replica and wait until each has built its
        callable."""
        cls = _actor.remote(_ReplicaActor).options(**self._replica_opts())
        dep = self.deployment
        replicas = [cls.remote(dep.cls_or_fn, dep.init_args,
                               dep.init_kwargs)
                    for _ in range(dep.num_replicas)]
        with self._lock:
            self.replicas = replicas
            self.inflight = {r: 0 for r in replicas}
        try:
            _actor.get([r.ping.remote() for r in replicas], timeout=timeout)
        except BaseException:
            self.stop()
            raise

    def stop(self) -> None:
        with self._lock:
            replicas, self.replicas = self.replicas, []
            self.inflight.clear()
        shut = [r.shutdown.remote() for r in replicas]
        try:
            _actor.wait(shut, num_returns=len(shut), timeout=10)
        finally:
            for r in replicas:
                _actor.kill(r)

    def pick(self):
        """The replica with the fewest requests in flight (the first of
        equals), counted as started; raises ``OverloadError`` past the
        admission bound."""
        dep = self.deployment
        with self._lock:
            if not self.replicas:
                raise RuntimeError(
                    f"deployment {dep.name!r} has no live replicas")
            total = sum(self.inflight.values())
            if dep.max_queued_requests is not None and total >= (
                    len(self.replicas) * dep.max_ongoing_requests
                    + dep.max_queued_requests):
                raise OverloadError(
                    f"deployment {dep.name!r} is over its admission bound "
                    f"(max_queued_requests); retry with backoff")
            replica = min(self.replicas, key=lambda r: self.inflight[r])
            self.inflight[replica] += 1
            return replica

    def done(self, replica) -> None:
        with self._lock:
            if replica in self.inflight:
                self.inflight[replica] = max(0, self.inflight[replica] - 1)

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {"num_replicas": len(self.replicas),
                    "target_replicas": self.deployment.num_replicas,
                    "inflight": {r._actor_id: n
                                 for r, n in self.inflight.items()}}


def _state(name: str) -> "_DeploymentState":
    with _app_lock:
        state = _deployments.get(name)
    if state is None:
        raise ValueError(f"no deployment named {name!r}")
    return state


class DeploymentHandle:
    """reference: serve/handle.py:1041 — ``.remote()`` routes a request;
    ``options(stream=True)`` returns a generator of refs over a generator
    method's yielded items (token streaming)."""

    def __init__(self, name: str, method: str = "__call__",
                 multiplexed_model_id: Optional[str] = None,
                 stream: bool = False):
        if multiplexed_model_id is not None:
            raise NotImplementedError(
                f"model multiplexing is not ported yet: {PART_2}")
        self._name = name
        self._method = method
        self._stream = stream

    def options(self, method_name: Optional[str] = None,
                multiplexed_model_id: Optional[str] = None,
                stream: Optional[bool] = None) -> "DeploymentHandle":
        return DeploymentHandle(self._name, method_name or self._method,
                                multiplexed_model_id,
                                self._stream if stream is None else stream)

    def __getattr__(self, item):
        if item.startswith("_"):
            raise AttributeError(item)
        return DeploymentHandle(self._name, item, None, self._stream)

    def remote(self, *args, **kwargs):
        from ..util import telemetry
        t_route = time.perf_counter()
        tags = {"deployment": self._name}
        state = _state(self._name)
        try:
            replica = state.pick()
        except OverloadError:
            telemetry.inc("ray_tpu_serve_shed_total", tags=tags)
            raise
        except RuntimeError:
            telemetry.inc("ray_tpu_serve_request_errors_total", tags=tags)
            raise
        telemetry.inc("ray_tpu_serve_requests_total", tags=tags)

        def finished(*_):
            state.done(replica)
            telemetry.observe("ray_tpu_serve_request_latency_seconds",
                              time.perf_counter() - t_route, tags=tags)

        if self._stream:
            gen = replica.handle_request_stream.options(
                num_returns="streaming").remote(self._method, args, kwargs)

            def stream_refs():
                try:
                    yield from gen
                finally:
                    finished()
            return stream_refs()
        ref = replica.handle_request.remote(self._method, args, kwargs)
        ref.future().add_done_callback(finished)
        return ref


def run(app: Application, *, name: Optional[str] = None,
        route_prefix: Optional[str] = None,
        http_port: Optional[int] = None) -> DeploymentHandle:
    """Start the deployment's replicas and return a handle (reference:
    serve/api.py:902).  A deployment of the same name is replaced."""
    dep = app.deployment if isinstance(app, Application) else app
    if http_port is not None:
        raise NotImplementedError(
            f"the HTTP ingress (run(http_port=...)) is not ported yet: "
            f"{PART_2}")
    _refuse_autoscaling(dep.autoscaling_config)
    if dep.num_tpus > 1:
        raise NotImplementedError(
            f"num_tpus={dep.num_tpus}: a replica holds one card (its "
            f"ray_actor_options 'device'); more per replica is not ported")
    state = _DeploymentState(dep)
    with _app_lock:
        old = _deployments.pop(dep.name, None)
    if old is not None:
        old.stop()
    state.start()
    with _app_lock:
        _deployments[dep.name] = state
    return DeploymentHandle(dep.name)


def get_deployment_handle(name: str) -> DeploymentHandle:
    _state(name)
    return DeploymentHandle(name)


def status() -> Dict[str, Dict[str, Any]]:
    with _app_lock:
        states = list(_deployments.items())
    return {name: s.status() for name, s in states}


def shutdown() -> None:
    """Stop every deployment (its replicas' ``shutdown``, then kill)."""
    with _app_lock:
        states = list(_deployments.values())
        _deployments.clear()
    for s in states:
        s.stop()


def multiplexed(*_args, **_kwargs):
    """Model multiplexing (JAX: ``serve.multiplexed``) is not ported."""
    raise NotImplementedError(f"model multiplexing is not ported yet: "
                              f"{PART_2}")


def add_grpc_service(*_args, **_kwargs):
    """The gRPC ingress (JAX: ``serve.add_grpc_service``) is not
    ported."""
    raise NotImplementedError(f"the gRPC ingress is not ported yet: "
                              f"{PART_2}")
