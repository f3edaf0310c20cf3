"""Per-worker training context and the report API (counterpart of
ray_tpu/train/_context.py).

``report()`` publishes metrics (and optionally a legacy checkpoint) to the
controller through the control plane (``ray_tpu_torch._control``);
``save_checkpoint()`` writes this rank's shards through the async sharded
checkpoint subsystem, which the controller commits once every rank acked.
The drain half of JAX's context (urgent checkpoint on a preemption notice)
waits with drain notices: ROADMAP Queue 1 item 3(c), "drain notices".
"""

from __future__ import annotations

import os
import pickle
import time
import uuid
from typing import Any, Dict, Optional

from ..checkpoint.manager import Checkpoint

_context: Optional["TrainContext"] = None


class TrainContext:
    def __init__(self, run_id: str, rank: int, world_size: int,
                 local_rank: int, storage_path: str,
                 experiment_name: str,
                 latest_checkpoint: Optional[str] = None,
                 num_slices: int = 1,
                 checkpoint_options: Optional[Dict[str, Any]] = None,
                 mesh_info: Optional[Dict[str, Any]] = None,
                 device=None):
        self.run_id = run_id
        self._rank = rank
        self._world_size = world_size
        self._local_rank = local_rank
        self.storage_path = storage_path
        self.experiment_name = experiment_name
        self._latest_checkpoint = latest_checkpoint
        self.num_slices = num_slices
        #: This worker's device: ``"cpu"``, or its card.
        self.device = device
        self._ckpt_options = dict(checkpoint_options or {})
        self._ckpt_client = None
        self._report_seq = 0
        # Unique per worker incarnation: keeps report keys distinct across
        # failure-recovery restarts (seq restarts at 0 in a fresh worker).
        self._incarnation = uuid.uuid4().hex[:8]
        # Report-to-report interval = one observed step: the wall stamp
        # anchors the span, the interval is measured on the monotonic
        # clock.
        self._last_report_wall = time.time()
        self._last_report_mono = time.monotonic()
        self._mesh_info = dict(mesh_info or {})
        self._mesh = None

    # -- mesh runtime -------------------------------------------------------

    def mesh(self):
        """The group's global mesh, built on first use over the worker
        group's ``torch.distributed`` world from the controller-resolved
        axes; a pure data-parallel mesh when no MeshConfig was given."""
        if self._mesh is None:
            from ..parallel.mesh import MeshSpec
            from .mesh.runtime import build_worker_mesh
            axes = self._mesh_info.get("axes") or {}
            num_slices = int(self._mesh_info.get("num_slices",
                                                 self.num_slices) or 1)
            if axes:
                spec = MeshSpec(num_slices=num_slices,
                                **{a: int(s) for a, s in axes.items()})
            else:
                spec = MeshSpec(dp=self._world_size, num_slices=num_slices)
            self._mesh = build_worker_mesh(spec, self.device)
        return self._mesh

    def sharding_rules(self):
        """Default logical-axis rules plus the MeshConfig's overrides (the
        one merge ``MeshConfig.sharding_rules`` uses too)."""
        from .mesh.config import rules_with_overrides
        return rules_with_overrides(self._mesh_info.get("rules"))

    def get_world_rank(self) -> int:
        return self._rank

    def get_world_size(self) -> int:
        return self._world_size

    def get_local_rank(self) -> int:
        return self._local_rank

    def get_experiment_name(self) -> str:
        return self.experiment_name

    def get_checkpoint(self) -> Optional[Checkpoint]:
        if self._latest_checkpoint and os.path.exists(self._latest_checkpoint):
            return Checkpoint(self._latest_checkpoint)
        return None

    # -- sharded checkpoint subsystem ---------------------------------------

    def checkpoint_client(self):
        """This worker's save/restore client."""
        if self._ckpt_client is None:
            from ..checkpoint.manager import WorkerCheckpointClient, _dir_step
            opts = self._ckpt_options
            start = 0
            if self._latest_checkpoint:
                # Resume the auto-step sequence past the restored
                # checkpoint: a restarted worker never overwrites a
                # committed step directory.
                s = _dir_step(os.path.basename(
                    os.path.normpath(self._latest_checkpoint)))
                if s is not None:
                    start = s + 1
            self._ckpt_client = WorkerCheckpointClient(
                run_id=self.run_id, rank=self._rank,
                world_size=self._world_size,
                run_root=os.path.join(os.path.abspath(self.storage_path),
                                      self.experiment_name),
                experiment=self.experiment_name,
                async_save=opts.get("async_save", True),
                max_inflight=opts.get("max_inflight", 2),
                emergency_replica=opts.get("emergency_replica", False),
                initial_step=start,
                generation=opts.get("generation"))
        return self._ckpt_client

    def teardown(self) -> None:
        """Flush and close the async checkpoint writer (at the end of the
        train fn, so every submitted save acks before the worker reports
        success)."""
        if self._ckpt_client is not None:
            self._ckpt_client.close()
            self._ckpt_client = None


def set_context(ctx: Optional[TrainContext]) -> None:
    global _context
    _context = ctx


def get_context() -> TrainContext:
    if _context is None:
        raise RuntimeError(
            "ray_tpu_torch.train.get_context() called outside a train "
            "worker")
    return _context


def report(metrics: Dict[str, Any],
           checkpoint: Optional[Checkpoint] = None) -> None:
    """Report metrics (and a checkpoint) from inside the train fn."""
    ctx = get_context()
    ctx._report_seq += 1
    from .._control import _control
    from ..profiler import attribution
    from ..util import telemetry
    now = time.time()
    now_mono = time.monotonic()
    ckpt_s = telemetry.pop_checkpoint_seconds()
    # seq 1's window is init and warm-up, not a step: no remainder.
    step_s = (now_mono - ctx._last_report_mono) \
        if ctx._report_seq > 1 else None
    phases = attribution.finalize_step_phases(
        attribution.pop_phases(), step_s, ckpt_s)
    payload = {
        "metrics": dict(metrics),
        "rank": ctx.get_world_rank(),
        "seq": ctx._report_seq,
        "time": now,
        # Same-process monotonic stamp for the watchdog's intervals,
        # scoped by the incarnation (another process, another base).
        "mono": now_mono,
        "incarnation": ctx._incarnation,
        "pid": os.getpid(),
        "checkpoint_dir": checkpoint.path if checkpoint else None,
        "ckpt_seconds": ckpt_s,
        "phases": phases,
    }
    _note_step(ctx, now, now_mono, metrics, phases)
    _control("kv_put",
             f"train/{ctx.run_id}/report/{ctx.get_world_rank()}/"
             f"{ctx._incarnation}/{ctx._report_seq}",
             pickle.dumps(payload))


def save_checkpoint(tree: Any, metrics: Optional[Dict[str, Any]] = None,
                    *, shard_spec=None, step: Optional[int] = None,
                    sync: Optional[bool] = None) -> str:
    """Save this rank's shards of ``tree``; returns the checkpoint
    directory.  An async save (the default, ``CheckpointConfig.async_save``)
    blocks only for the host snapshot; the checkpoint becomes ``latest``
    once every rank's shard landed and the controller committed the
    manifest.  ``shard_spec(key, leaf) -> (global_shape, index)`` declares
    the slice of a global array this rank holds (DTensors carry theirs)."""
    ctx = get_context()
    if ctx._mesh is not None:
        # Stamp the saving mesh's shape: a restore onto another shape
        # counts as a mesh reshape.
        from .mesh.reshape import save_metrics as _mesh_save_metrics
        metrics = _mesh_save_metrics(ctx._mesh, metrics)
    return ctx.checkpoint_client().save(tree, metrics=metrics,
                                        shard_spec=shard_spec, step=step,
                                        sync=sync)


def load_checkpoint(placement=None) -> Optional[Any]:
    """The latest committed checkpoint's tree (CPU tensors), resharded to
    ``placement(key, global_shape) -> index`` (None: whole arrays).  None
    when the run has no checkpoint yet."""
    ctx = get_context()
    if not ctx._latest_checkpoint or \
            not os.path.exists(ctx._latest_checkpoint):
        return None
    return ctx.checkpoint_client().load(ctx._latest_checkpoint,
                                        placement=placement)


def get_mesh():
    """The worker group's global mesh (inside a train fn)."""
    return get_context().mesh()


def shard(tree: Any, logical_tree: Any):
    """Place a tree of host arrays onto the group mesh by a parallel tree
    of logical-axis tuples (every process passes the same full values; each
    keeps its own blocks)."""
    ctx = get_context()
    from .mesh.runtime import shard_tree
    return shard_tree(tree, logical_tree, ctx.mesh(),
                      rules=ctx.sharding_rules())


def shard_batch(batch: Any):
    """Place this process's LOCAL batch rows onto the mesh's data axes."""
    ctx = get_context()
    from .mesh.runtime import shard_batch_tree
    return shard_batch_tree(batch, ctx.mesh(), rules=ctx.sharding_rules())


def load_sharded(logical_tree: Any) -> Optional[Any]:
    """Restore the latest committed checkpoint onto the group mesh (the
    saved mesh shape may differ: each process reads only its blocks).
    None when the run has no checkpoint yet."""
    ctx = get_context()
    if not ctx._latest_checkpoint or \
            not os.path.exists(ctx._latest_checkpoint):
        return None
    from .mesh.reshape import restore_to_mesh, sharding_tree
    shardings = sharding_tree(logical_tree, ctx.mesh(),
                              rules=ctx.sharding_rules())
    client = ctx.checkpoint_client()
    return restore_to_mesh(
        ctx._latest_checkpoint, shardings,
        loader=lambda path, placement: client.load(path,
                                                   placement=placement),
        count_reshape=ctx.get_world_rank() == 0)


def _note_step(ctx: "TrainContext", now: float, now_mono: float,
               metrics: Dict[str, Any],
               phases: Optional[Dict[str, float]] = None) -> None:
    """Built-in train metrics from the report stream: each rank-0
    report-to-report interval is one step (histogram and span)."""
    from ..profiler import attribution
    from ..util import telemetry
    telemetry.inc("ray_tpu_train_reports_total")
    for key in ("tokens", "num_tokens", "tokens_per_step"):
        v = metrics.get(key)
        if isinstance(v, (int, float)) and v > 0:
            telemetry.inc("ray_tpu_train_tokens_total", v)
            break
    attribution.note_hbm_gauges()
    if ctx.get_world_rank() == 0 and ctx._report_seq > 1:
        dur = now_mono - ctx._last_report_mono
        if dur > 0:
            telemetry.observe("ray_tpu_train_step_seconds", dur)
            for phase, seconds in (phases or {}).items():
                telemetry.observe("ray_tpu_train_step_phase_seconds",
                                  seconds, tags={"phase": phase})
            telemetry._emit_span(
                "train_step", "train", ctx._last_report_wall,
                ctx._last_report_wall + dur,
                extra={"seq": ctx._report_seq, "run_id": ctx.run_id,
                       "phases": {k: round(v, 6)
                                  for k, v in (phases or {}).items()}})
    ctx._last_report_wall = now
    ctx._last_report_mono = now_mono
