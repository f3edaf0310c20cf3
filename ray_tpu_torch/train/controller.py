"""Train controller: worker group lifecycle, failure handling, reports
(counterpart of ray_tpu/train/controller.py).

A worker is a process the controller spawns (JAX: an actor), one per rank,
holding one card (rank r takes card r) or, with ``ScalingConfig(device=
"cpu")``, one CPU process over gloo.  The controller hosts the control plane
(``ray_tpu_torch._control``, a ``TCPStore`` server); each worker connects to
it, forms its process group on ``PrefixStore(f"train/{run_id}/pg/
{generation}")`` of that store (JAX: ``jax.distributed.initialize``), runs
the train fn with its ``TrainContext`` set, closes the context (every async
save acked) and writes its result under ``train/{run_id}/done/...``, with
its traceback when the fn raised and its telemetry.

On the first failure the controller kills EVERY process of the group (the
NCCL peers of a dead rank would hang), then the failure budget (a rolling
window when ``failure_window_s`` is set), bounded backoff and the crash-loop
breaker decide whether a fresh group resumes from the latest committed
checkpoint.  The train fn travels by reference: a module-level function,
which the spawned process imports.  Not ported: the drain (preemption)
protocol and elastic resizes (ROADMAP Queue 1 item 3(c)).
"""

from __future__ import annotations

import faulthandler
import json
import os
import pickle
import signal
import threading
import time
import traceback
import uuid
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from .._control import ControlPlane, _control, set_current
from ..checkpoint.manager import Checkpoint, CheckpointManager
from ..util import telemetry


#: A worker process of the port holds one card (or is one CPU rank).
DEVICES_PER_WORKER = 1


def todo(entry: str) -> str:
    """The message of an option the port refuses until a ROADMAP entry is
    done."""
    return f'not ported yet: ROADMAP Queue 1 item 3(c), "{entry}"'


class CrashLoopError(RuntimeError):
    """The same error signature recurred immediately N times: restarting
    will not fix a deterministic crash.  Raised (as ``Result.error``) by
    the crash-loop circuit breaker with the diagnosis bundle path."""

    def __init__(self, signature: str, count: int,
                 last_error: Optional[BaseException] = None,
                 bundle_path: Optional[str] = None):
        super().__init__(
            f"crash loop: {count} consecutive restarts died with the "
            f"same signature [{signature}]"
            + (f"; diagnosis bundle: {bundle_path}" if bundle_path
               else ""))
        self.signature = signature
        self.count = count
        self.last_error = last_error
        self.bundle_path = bundle_path


class TrainWorkerError(RuntimeError):
    """A worker's train fn raised (its traceback follows the first line) or
    its process died."""

    def __init__(self, rank: int, message: str, tb: str = ""):
        super().__init__(f"train worker rank {rank} {message}"
                         + (f"\n{tb}" if tb else ""))
        self.rank = rank
        self.traceback = tb


def _error_signature(exc: BaseException) -> str:
    """Stable identity of a failure for crash-loop detection: type plus
    the first line of the message."""
    first = str(exc).splitlines()[0] if str(exc) else ""
    return f"{type(exc).__name__}: {first[:200]}"


def _key(run_id: str, what: str, generation: int, rank: int) -> str:
    return f"train/{run_id}/{what}/{generation}/{rank}"


# -- worker side ---------------------------------------------------------------


class TrainWorker:
    """One training process of the group (runs in the spawned process)."""

    def __init__(self, rank: int, world_size: int, run_id: str,
                 device: Optional[str]):
        self.rank = rank
        self.world_size = world_size
        self.run_id = run_id
        self.device = device
        self._dist_initialized = False

    def setup_dist(self, plane: ControlPlane, generation: int) -> None:
        """Form the group's process group (gloo on CPU workers, NCCL on
        cards) on this incarnation's prefix of the control-plane store."""
        import torch.distributed as dist
        dist.init_process_group(
            "gloo" if self.device == "cpu" else "nccl",
            store=dist.PrefixStore(f"train/{self.run_id}/pg/{generation}",
                                   plane.store),
            rank=self.rank, world_size=self.world_size)
        self._dist_initialized = True

    def run(self, fn: Callable, config: Optional[Dict[str, Any]],
            ctx_info: Dict[str, Any]) -> str:
        from . import _context
        ctx = _context.TrainContext(
            run_id=self.run_id, rank=self.rank,
            world_size=self.world_size, local_rank=self.rank,
            storage_path=ctx_info["storage_path"],
            experiment_name=ctx_info["experiment_name"],
            latest_checkpoint=ctx_info.get("latest_checkpoint"),
            num_slices=ctx_info.get("num_slices", 1),
            checkpoint_options=ctx_info.get("checkpoint"),
            mesh_info=ctx_info.get("mesh"), device=ctx_info["device"])
        _context.set_context(ctx)
        try:
            if config is not None:
                fn(config)
            else:
                fn()
            # Every submitted save must have published and acked before
            # the controller sees this rank finish.
            ctx.teardown()
            return "ok"
        finally:
            _context.set_context(None)

    def shutdown_dist(self) -> None:
        if self._dist_initialized:
            import torch.distributed as dist
            dist.destroy_process_group()
            self._dist_initialized = False


#: Seconds between a worker's looks for a profile request.
PROFILE_POLL_S = 0.25


def _profile_listener(plane: ControlPlane, run_id: str, generation: int,
                      rank: int) -> None:
    """A worker's answer to the watchdog's profile requests: on a thread of
    its own (a hung train fn holds the main thread), it captures this
    process for the requested window and puts the record back."""
    from ..profiler.capture import capture_profile
    seen = None
    req_key = _key(run_id, "profile_req", generation, 0)
    while True:
        time.sleep(PROFILE_POLL_S)
        try:
            raw = plane.kv_get(req_key)
        except Exception:  # noqa: BLE001 - the controller is gone
            return
        if raw is None or raw == seen:
            continue
        seen = raw
        req = pickle.loads(raw)
        rec = capture_profile(f"rank{rank}", req["duration_s"],
                              driver_wall_s=req["driver_wall_s"])
        plane.kv_put(_key(run_id, f"profile_rec/{req['seq']}", generation,
                          rank), pickle.dumps(rec))


def _worker_main(rank: int, world: int, run_id: str, host: str, port: int,
                 generation: int, spec: Dict[str, Any]) -> None:
    """Entry point of a spawned worker process."""
    import torch
    status: Dict[str, Any] = {"status": "ok", "pid": os.getpid()}
    plane = ControlPlane.connect(host, port)
    set_current(plane)
    if spec["profile_listener"]:
        threading.Thread(target=_profile_listener,
                         args=(plane, run_id, generation, rank),
                         daemon=True, name="train-profile-listener").start()
    os.makedirs(os.path.dirname(spec["stack_file"]), exist_ok=True)
    stacks = open(spec["stack_file"], "w")
    # The watchdog's bundle asks every worker for its stacks by SIGUSR1.
    faulthandler.register(signal.SIGUSR1, file=stacks, all_threads=True)
    # Kernel builds and first launches charged to tracked sites, the
    # port's train step among them (profiler/recompile.py), on by default
    # in train workers as in JAX's (RAY_TPU_RECOMPILE_DETECT=0 opts out).
    if os.environ.get("RAY_TPU_RECOMPILE_DETECT", "1") != "0":
        from ..profiler import recompile
        recompile.install()
    try:
        device = spec["device"]
        if device == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(rank)
        plane.kv_put(_key(run_id, "alive", generation, rank),
                     str(os.getpid()).encode())
        worker = TrainWorker(rank, world, run_id, device)
        if spec["distributed"]:
            worker.setup_dist(plane, generation)
        plane.kv_put(_key(run_id, "formed", generation, rank), b"1")
        # The controller records the formed mesh, then sends the context.
        ctx_info = pickle.loads(plane.wait(
            _key(run_id, "go", generation, 0), spec["formation_timeout_s"]))
        try:
            worker.run(spec["fn"], spec["config"],
                       dict(ctx_info, device=device or f"cuda:{rank}"))
        finally:
            worker.shutdown_dist()
    except BaseException as e:  # noqa: BLE001 - reported to the controller
        tb = traceback.format_exc()
        status.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=tb)
    status["telemetry"] = telemetry.snapshot()
    plane.kv_put(_key(run_id, "done", generation, rank),
                 pickle.dumps(status))


@contextmanager
def _environ(env: Dict[str, str]):
    """``env`` set in this process's environment while a child spawns (a
    spawned interpreter inherits it from its first instruction)."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# -- controller side -----------------------------------------------------------


@dataclass
class WorkerGroupState:
    procs: List[Any] = field(default_factory=list)
    generation: int = 0
    stack_files: List[str] = field(default_factory=list)


class TrainController:
    """Drives the worker group to completion (runs in the driver)."""

    def __init__(self, train_fn: Callable, train_loop_config,
                 scaling_config, run_config):
        from .watchdog import TrainWatchdog
        self.train_fn = train_fn
        self.train_loop_config = train_loop_config
        self.scaling = scaling_config
        self.run_config = run_config
        self.run_id = uuid.uuid4().hex[:12]
        #: "cpu", or None: the cards.
        self.device = scaling_config.device
        self.mesh_config = getattr(scaling_config, "mesh_config", None)
        if self.mesh_config is not None:
            if self.mesh_config.devices_per_worker != DEVICES_PER_WORKER:
                raise ValueError(
                    "MeshConfig.devices_per_worker must be 1: a worker "
                    "process of the port holds one card")
            self.mesh_config.validate_scaling(scaling_config)
        #: Mesh axis sizes of the current incarnation (Result.mesh).
        self._mesh_axes: Optional[Dict[str, int]] = None
        self.manager = CheckpointManager(
            run_config.storage_path, run_config.name,
            num_to_keep=run_config.checkpoint_config.num_to_keep)
        self.run_root = self.manager.root
        self._reports: List[Dict[str, Any]] = []
        self._seen_report_keys: set = set()
        self._seen_ack_keys: set = set()
        self._phase_totals: Dict[str, float] = {}
        self.goodput = telemetry.GoodputTracker(initial_phase="init")
        self.watchdog = TrainWatchdog(
            self.run_id, getattr(run_config, "watchdog", None),
            dump=self._debug_dump)
        self._group: Optional[WorkerGroupState] = None
        #: Sequence number of the last watchdog profile request.
        self._profile_seq = 0
        # Monotonic stamp of the newest durable checkpoint: the failure
        # path books "lost" work from here, not from group start.
        self._last_ckpt_mono = 0.0
        self._failure_times: "deque[float]" = deque()
        self._last_error_sig: Optional[str] = None
        self._crash_streak = 0
        #: Seconds from spawning each incarnation to its formed group.
        self.formation_seconds: List[float] = []
        self.world_size_history: List[int] = []

    # -- worker group -------------------------------------------------------

    def _resolved_axes(self, world: int) -> Dict[str, int]:
        """Mesh axis sizes a group of ``world`` processes forms (raises
        ValueError when the mesh cannot tile that world)."""
        from ..parallel.mesh import MeshSpec
        total = world * DEVICES_PER_WORKER
        if self.mesh_config is not None:
            spec = self.mesh_config.spec_for(total, self.scaling.num_slices)
        else:
            spec = MeshSpec(dp=total)
        return {a: s for a, s in spec.shape()}

    def _note_mesh_formed(self, world: int) -> None:
        """Record a formed group's mesh shape: the axis gauges, the reshape
        counter, the control-plane status record and Result.mesh."""
        from .mesh.runtime import note_mesh_axes, publish_mesh_status
        axes = self._resolved_axes(world)
        if self._mesh_axes is not None and axes != self._mesh_axes:
            telemetry.inc("ray_tpu_train_mesh_reshapes_total")
        self._mesh_axes = axes
        note_mesh_axes(axes)
        publish_mesh_status(self.run_id, axes, world, DEVICES_PER_WORKER)

    def _ctx_info(self, axes: Dict[str, int]) -> Dict[str, Any]:
        """What each worker's TrainContext starts from; ``axes``: this
        incarnation's resolved mesh."""
        ckpt_cfg = self.run_config.checkpoint_config
        return {
            "storage_path": self.run_config.storage_path,
            "experiment_name": self.run_config.name,
            "latest_checkpoint": self.manager.latest(),
            "num_slices": self.scaling.num_slices,
            "mesh": {
                "axes": dict(axes) if self.mesh_config is not None else {},
                "num_slices": self.scaling.num_slices,
                "devices_per_worker": DEVICES_PER_WORKER,
                "rules": dict(self.mesh_config.rules or {})
                if self.mesh_config is not None else {},
                "configured": self.mesh_config is not None,
            },
            "checkpoint": {
                "async_save": ckpt_cfg.async_save,
                "max_inflight": ckpt_cfg.max_inflight,
                "emergency_replica": ckpt_cfg.emergency_replica,
                # Acks carry it: the manager drops a dead group's.
                "generation": len(self.world_size_history),
            },
        }

    def _start_group(self, n: int) -> WorkerGroupState:
        """Spawn ``n`` workers; returns once every rank is alive and its
        process group formed.  Raises (and kills the group) when a rank
        dies first or formation outlasts ``formation_timeout_s``."""
        import torch.multiprocessing as mp
        self._resolved_axes(n)   # the mesh must tile n before any spawn
        generation = len(self.world_size_history) - 1
        ctx = mp.get_context("spawn")
        group = WorkerGroupState(generation=generation)
        self._group = group
        spec = {"fn": self.train_fn, "config": self.train_loop_config,
                "device": self.device,
                "formation_timeout_s": self.scaling.formation_timeout_s,
                "distributed": n > 1 or self.scaling.force_distributed,
                # Workers poll for the watchdog's profile requests only
                # where its bundles ask for a profile.
                "profile_listener":
                    self.watchdog.config.bundle_profile_s > 0}
        t0 = time.monotonic()
        for rank in range(n):
            stack_file = os.path.join(
                self.run_root, "diagnostics", "stacks",
                f"{self.run_id}-g{generation}-rank{rank}.txt")
            group.stack_files.append(stack_file)
            with _environ(self.scaling.env_per_worker or {}):
                p = ctx.Process(
                    target=_worker_main, daemon=True,
                    args=(rank, n, self.run_id, self.plane.host,
                          self.plane.port, generation,
                          dict(spec, stack_file=stack_file)))
                p.start()
            group.procs.append(p)
        form_t = self.scaling.formation_timeout_s
        deadline = t0 + form_t
        waiting = set(range(n))
        while waiting:
            for rank in list(waiting):
                if _control("kv_get", _key(self.run_id, "formed",
                                           generation, rank)) is not None:
                    waiting.discard(rank)
                    continue
                err = self._worker_result(group, rank)
                if isinstance(err, Exception):
                    raise err
            if waiting and time.monotonic() > deadline:
                raise TimeoutError(
                    f"worker group did not form within {form_t} s "
                    f"(ranks {sorted(waiting)} missing)")
            if waiting:
                time.sleep(0.02)
        self.formation_seconds.append(time.monotonic() - t0)
        return group

    def _teardown_group(self, group: WorkerGroupState) -> None:
        """Kill every process of the group and drop its control keys."""
        for p in group.procs:
            if p.is_alive():
                p.kill()
        for p in group.procs:
            p.join(timeout=30)
        for what in ("alive", "formed", "go", "done"):
            for rank in range(len(group.procs)):
                _control("kv_del",
                         _key(self.run_id, what, group.generation, rank))

    def _worker_result(self, group: WorkerGroupState, rank: int):
        """None while rank runs; "ok" when its fn returned; else the
        error (its traceback, or its death)."""
        key = _key(self.run_id, "done", group.generation, rank)
        raw = _control("kv_get", key)
        proc = group.procs[rank]
        if raw is None and proc.exitcode is not None:
            raw = _control("kv_get", key)   # written before the exit
            if raw is None:
                # No pid on the first line: the crash-loop signature.
                return TrainWorkerError(
                    rank, f"died (exit code {proc.exitcode})",
                    f"pid {proc.pid}")
        if raw is None:
            return None
        rec = pickle.loads(raw)
        telemetry.merge_remote(f"{self.run_id}/{group.generation}/{rank}",
                               rec.get("telemetry") or {})
        if rec["status"] == "ok":
            return "ok"
        return TrainWorkerError(rank, f"raised {rec['error']}",
                                rec.get("traceback", ""))

    # -- diagnostics ---------------------------------------------------------

    def _debug_dump(self, name: str, extra: Dict[str, Any],
                    capture_stacks: bool = False,
                    profile_s: Optional[float] = None) -> str:
        """Write one diagnosis bundle (JSON) under ``<run>/diagnostics``;
        with ``capture_stacks``, every live worker's Python stacks (its
        faulthandler answers SIGUSR1); with ``profile_s``, a profile of
        that length of the driver and every live worker, merged into one
        trace beside the bundle (JAX: ``debug_dump``'s profile).  Returns
        its path."""
        bundle = {"name": name, "run_id": self.run_id, "time": time.time(),
                  **extra}
        group = self._group
        where = os.path.join(self.run_root, "diagnostics")
        os.makedirs(where, exist_ok=True)
        stamp = time.time_ns()
        if profile_s:
            bundle["profile"] = self._bundle_profile(
                group, float(profile_s),
                os.path.join(where, f"{name}-{stamp}-profile.json"))
        if capture_stacks and group is not None:
            live = [(r, p) for r, p in enumerate(group.procs)
                    if p.is_alive()]
            for _r, p in live:
                os.kill(p.pid, signal.SIGUSR1)
            time.sleep(0.5)
            stacks = {}
            for r, _p in live:
                try:
                    with open(group.stack_files[r]) as f:
                        stacks[str(r)] = f.read()
                except OSError as e:
                    stacks[str(r)] = f"unreadable: {e}"
            bundle["stacks"] = stacks
        path = os.path.join(where, f"{name}-{stamp}.json")
        with open(path, "w") as f:
            json.dump(bundle, f, indent=1, default=str)
        return path

    def _bundle_profile(self, group: Optional[WorkerGroupState],
                        duration_s: float, path: str) -> Dict[str, Any]:
        """A ``duration_s`` capture of the driver and each live worker
        (each answers on its profile-listener thread), merged and written
        to ``path``: {"path", "workers", "unresponsive", "num_events"}."""
        from ..profiler import COLLECT_TIMEOUT_S
        from ..profiler.capture import capture_profile
        from ..profiler.merge import merge_records, write_trace
        self._profile_seq += 1
        seq = self._profile_seq
        live = [] if group is None else [
            r for r, p in enumerate(group.procs) if p.is_alive()]
        t0 = time.time()
        if group is not None:
            _control("kv_put", _key(self.run_id, "profile_req",
                                    group.generation, 0),
                     pickle.dumps({"seq": seq, "duration_s": duration_s,
                                   "driver_wall_s": t0}))
        records = [capture_profile("driver", duration_s,
                                   driver_wall_s=t0, is_driver=True)]
        deadline = time.monotonic() + COLLECT_TIMEOUT_S
        pending = list(live)
        while pending and time.monotonic() < deadline:
            for r in list(pending):
                raw = _control("kv_get", _key(
                    self.run_id, f"profile_rec/{seq}", group.generation, r))
                if raw is not None:
                    records.append(pickle.loads(raw))
                    pending.remove(r)
            if pending:
                time.sleep(0.1)
        doc = merge_records(records, meta={
            "duration_s": duration_s, "driver_t0_wall_s": t0,
            "unresponsive": [f"rank{r}" for r in pending]})
        write_trace(path, doc)
        return {"path": path,
                "workers": [rec.get("worker_id") for rec in records],
                "unresponsive": [f"rank{r}" for r in pending],
                "num_events": len(doc["traceEvents"])}

    # -- reports ------------------------------------------------------------

    def _poll_reports(self) -> None:
        prefix = f"train/{self.run_id}/report/"
        for key in _control("kv_keys", prefix):
            if key in self._seen_report_keys:
                continue
            self._seen_report_keys.add(key)
            data = _control("kv_get", key)
            if data is None:
                continue
            payload = pickle.loads(data)
            self._reports.append(payload)
            self.watchdog.note_report(payload["rank"], payload["time"],
                                      payload.get("pid"),
                                      report_mono=payload.get("mono"),
                                      incarnation=payload.get("incarnation"))
            if payload["rank"] == 0:
                # Worker-measured checkpoint time happened inside what the
                # controller observes as the "step" phase: reattribute.
                self.goodput.reattribute(
                    "checkpoint", payload.get("ckpt_seconds", 0.0) or 0.0)
                phases = payload.get("phases") or {}
                for phase, seconds in phases.items():
                    if seconds > 0:
                        self._phase_totals[phase] = \
                            self._phase_totals.get(phase, 0.0) + seconds
                # Waiting on data is idle devices, not productive time.
                self.goodput.reattribute(
                    "data_wait", phases.get("data_wait", 0.0) or 0.0)
                if payload.get("checkpoint_dir"):
                    self.manager.register(payload["checkpoint_dir"],
                                          payload["metrics"])
                    self._last_ckpt_mono = time.monotonic()
            # Consumed: the payload lives on in self._reports.
            _control("kv_del", key)
        self._poll_ckpt_acks()

    def _poll_ckpt_acks(self) -> None:
        """Collect per-rank shard acks and commit a step's manifest once
        its ack set is complete (a crash before the commit leaves
        ``latest`` untouched)."""
        from ..checkpoint.manager import ack_prefix
        for key in _control("kv_keys", ack_prefix(self.run_id)):
            if key in self._seen_ack_keys:
                continue
            data = _control("kv_get", key)
            if data is None:
                continue
            self._seen_ack_keys.add(key)
            self.manager.note_ack(pickle.loads(data))
            _control("kv_del", key)
        if self.manager.commit_ready():
            self._last_ckpt_mono = time.monotonic()

    def _run_incarnation(self, group: WorkerGroupState,
                         world: int) -> Optional[Exception]:
        """Start the train fn on a formed group (every worker waits for
        this context) and drive it until every rank finished or one
        failed: poll reports and acks, and book lost work on failure."""
        _control("kv_put", _key(self.run_id, "go", group.generation, 0),
                 pickle.dumps(self._ctx_info(self._mesh_axes)))
        self.goodput.enter("step")
        t_step = time.monotonic()
        error: Optional[Exception] = None
        pending = set(range(world))
        while pending and error is None:
            time.sleep(0.05)
            self._poll_reports()
            for rank in sorted(pending):
                res = self._worker_result(group, rank)
                if res is None:
                    continue
                pending.discard(rank)
                # A finished rank legitimately stops reporting.
                self.watchdog.note_done(rank)
                if res != "ok":
                    error = res
                    break
        self._poll_reports()
        if error is not None:
            # Step time since the last committed checkpoint produced no
            # surviving work (the restart replays it).
            self.goodput.reattribute(
                "lost", time.monotonic() - max(t_step, self._last_ckpt_mono))
        return error

    def _trip_crash_loop(self, signature: str,
                         last_error: Exception) -> CrashLoopError:
        """Circuit breaker tripped: write the diagnosis bundle and build
        the terminal error (forensics are best-effort)."""
        bundle_path = None
        diagnosis = {
            "signature": signature,
            "consecutive": self._crash_streak,
            "world_size_history": list(self.world_size_history),
            "run_id": self.run_id,
            "experiment": self.run_config.name,
            "goodput": self.goodput.summary(),
            "last_error": str(last_error),
        }
        try:
            _control("export_event", "EXPORT_TRAIN_WATCHDOG",
                     {"kind": "crash_loop", "run_id": self.run_id,
                      "signature": signature,
                      "consecutive": self._crash_streak})
            bundle_path = self._debug_dump("crash_loop",
                                           {"crash_loop": diagnosis})
        except Exception as e:  # noqa: BLE001 - forensics best-effort
            telemetry.note_swallowed("train.crash_loop_bundle", e)
        return CrashLoopError(signature, self._crash_streak,
                              last_error=last_error, bundle_path=bundle_path)

    # -- main loop ----------------------------------------------------------

    def run(self):
        from .trainer import Result
        self.plane = ControlPlane.serve()
        set_current(self.plane)
        failures = 0
        error: Optional[Exception] = None
        fc = self.run_config.failure_config
        self._backoff_s = fc.restart_backoff_initial_s
        self.watchdog.start()
        try:
            while True:
                self.goodput.enter(
                    "init" if not self.world_size_history else "restart")
                world = self.scaling.num_workers
                self.world_size_history.append(world)
                # A fresh incarnation: stale rank clocks and acks of the
                # torn-down group must not count against the new one.
                self.watchdog.reset_ranks()
                self.manager.reset_pending_acks(
                    generation=len(self.world_size_history))
                t_form = time.monotonic()
                error = None
                group: Optional[WorkerGroupState] = None
                try:
                    group = self._start_group(world)
                    self._note_mesh_formed(world)
                except Exception as e:  # noqa: BLE001 - restartable
                    # Formation failure: a failure like any other; the
                    # budget and backoff below decide on a retry.
                    error = e
                if group is not None and error is None:
                    error = self._run_incarnation(group, world)
                self.goodput.enter("idle")
                if self._group is not None:
                    self._teardown_group(self._group)
                    self._group = None
                if error is None:
                    break
                failures += 1
                now = time.monotonic()
                lifetime = now - t_form
                # Crash-loop breaker: the same signature dying right away
                # N times in a row is deterministic.
                sig = _error_signature(error)
                if sig == self._last_error_sig and \
                        lifetime < fc.crash_loop_window_s:
                    self._crash_streak += 1
                else:
                    self._crash_streak = 1
                self._last_error_sig = sig
                if fc.crash_loop_threshold and \
                        self._crash_streak >= fc.crash_loop_threshold:
                    error = self._trip_crash_loop(sig, error)
                    break
                # Failure budget: rolling window when configured, lifetime
                # counter otherwise.
                if fc.failure_window_s is not None:
                    self._failure_times.append(now)
                    cutoff = now - fc.failure_window_s
                    while self._failure_times and \
                            self._failure_times[0] < cutoff:
                        self._failure_times.popleft()
                    over_budget = len(self._failure_times) > fc.max_failures
                else:
                    over_budget = failures > fc.max_failures
                if over_budget:
                    break
                telemetry.inc("ray_tpu_train_worker_restarts_total", world)
                # Bounded exponential backoff; an incarnation that proved
                # stable resets the ladder.
                if fc.restart_backoff_initial_s > 0:
                    if lifetime >= fc.restart_backoff_reset_s:
                        self._backoff_s = fc.restart_backoff_initial_s
                    delay = min(self._backoff_s, fc.restart_backoff_max_s)
                    self._backoff_s = min(
                        self._backoff_s * fc.restart_backoff_factor,
                        fc.restart_backoff_max_s)
                    telemetry.observe(
                        "ray_tpu_train_restart_backoff_seconds", delay)
                    self.goodput.enter("restart")
                    time.sleep(delay)
        finally:
            self.watchdog.stop()
            self.goodput.finish()
            if self._group is not None:
                self._teardown_group(self._group)
            self._save_events()
            set_current(None)
            self.plane = None
        rank0 = sorted((r for r in self._reports if r["rank"] == 0),
                       key=lambda r: r["time"])
        last_metrics = rank0[-1]["metrics"] if rank0 else {}
        latest = self.manager.latest()
        total_phase_s = sum(self._phase_totals.values())
        step_phases = {
            "seconds": {k: round(v, 6)
                        for k, v in sorted(self._phase_totals.items())},
            "fraction": {k: round(v / total_phase_s, 4)
                         for k, v in sorted(self._phase_totals.items())}
            if total_phase_s > 0 else {},
        } if self._phase_totals else None
        return Result(
            metrics=last_metrics,
            checkpoint=Checkpoint(latest) if latest else None,
            error=error,
            all_reports=self._reports,
            num_failures=failures,
            world_size_history=self.world_size_history,
            goodput=self.goodput.summary(),
            step_phases=step_phases,
            mesh=dict(self._mesh_axes) if self._mesh_axes else None,
            formation_seconds=list(self.formation_seconds))

    def _save_events(self) -> None:
        """Append the run's exported events to ``<run>/events.jsonl`` (the
        control plane dies with the run)."""
        try:
            events = self.plane.events()
            if events:
                with open(os.path.join(self.run_root, "events.jsonl"),
                          "a") as f:
                    for ev in events:
                        f.write(json.dumps(ev, default=str) + "\n")
        except Exception as e:  # noqa: BLE001 - forensics best-effort
            telemetry.note_swallowed("train.save_events", e)
