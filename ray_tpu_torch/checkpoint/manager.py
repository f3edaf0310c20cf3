"""Checkpoint lifecycle: worker-side save client, coordinator-side manager
(a copy of ray_tpu/checkpoint/manager.py over the port's format and control
plane, without the emergency in-memory replicas: ``emergency_replica=True``
raises ``NotImplementedError``, see ``EMERGENCY_REPLICA_TODO``).

Two halves of one commit protocol:

* ``WorkerCheckpointClient`` runs inside each train worker.  ``save()``
  blocks only for the device->host snapshot (plus backpressure when the
  bounded write queue is full); the writer thread publishes the rank's
  shard pair and acks the coordinator over the control plane
  (``ray_tpu_torch._control``).
* ``CheckpointManager`` runs in the driver/controller.  It collects acks
  and, once EVERY rank of a step has acked, builds + commits the global
  ``manifest.json`` via tmp-file + atomic rename, registers the entry,
  enforces retention, and garbage-collects dead uncommitted directories.
  A checkpoint that was never committed is invisible to ``latest()`` —
  a crash mid-save can never be mistaken for a valid checkpoint.
"""

from __future__ import annotations

import json
import os
import pickle
import re
import shutil
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

from ..util import telemetry
from . import format as ckpt_format
from .async_writer import AsyncCheckpointWriter, WriteJob, publish_shard

#: Emergency replicas keep the newest shards in a peer's RAM, pinned in the
#: JAX package's host object store, which the port has no copy of.
EMERGENCY_REPLICA_TODO = (
    "emergency_replica=True is not ported: it needs the host object store "
    "(ray_tpu/checkpoint/replica.py); ROADMAP Queue 1 item 3(c), "
    "\"emergency replicas\"")

_STEP_DIR_RE = re.compile(r"^checkpoint_(\d+)$")


def step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"checkpoint_{step:06d}")


def _dir_step(name: str) -> Optional[int]:
    m = _STEP_DIR_RE.match(name)
    return int(m.group(1)) if m else None


def ack_prefix(run_id: str) -> str:
    """KV namespace the coordinator polls for shard acks."""
    return f"train/{run_id}/ckpt/"


def ack_key(run_id: str, step: int, rank: int, nonce: str) -> str:
    # The nonce is unique per worker incarnation: a restarted rank
    # re-saving the same step acks at a FRESH key, so the coordinator's
    # seen-key dedup can never hide the new ack behind the dead one.
    return f"{ack_prefix(run_id)}{step:08d}/{rank}/{nonce}"


class Checkpoint:
    """Handle to a checkpoint directory (reference: train/_checkpoint.py:56).

    Understands both the sharded v1 layout (``manifest.json``) and the
    legacy single-pickle layout (``pytree.pkl``).
    """

    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    def as_directory(self) -> str:
        return self.path

    def to_directory(self, dest: Optional[str] = None) -> str:
        """Materialize a copy of the checkpoint at ``dest``.

        The copy lands in a staging dir next to the target and is
        published with one atomic rename: a reader (or a crash) can never
        observe a half-copied directory at ``dest``.
        """
        dest = os.path.abspath(dest or tempfile.mkdtemp(prefix="ckpt_"))
        if dest == self.path:
            return dest
        parent = os.path.dirname(dest) or "."
        os.makedirs(parent, exist_ok=True)
        staging = tempfile.mkdtemp(prefix=os.path.basename(dest) + ".tmp",
                                   dir=parent)
        try:
            # copytree into the (empty) staging dir, then swing it in.
            shutil.copytree(self.path, staging, dirs_exist_ok=True)
            try:
                os.replace(staging, dest)
            except OSError:
                # dest already exists (mkdtemp pre-created it, or a prior
                # copy landed): atomically swap it out of the namespace
                # first, then retire the old tree.
                old = tempfile.mkdtemp(prefix=os.path.basename(dest)
                                       + ".old", dir=parent)
                os.replace(dest, os.path.join(old, "d"))
                os.replace(staging, dest)
                shutil.rmtree(old, ignore_errors=True)
        except BaseException:
            shutil.rmtree(staging, ignore_errors=True)
            raise
        return dest

    # -- pytree convenience -------------------------------------------------

    @classmethod
    def from_pytree(cls, tree: Any, path: str,
                    use_orbax: bool = False) -> "Checkpoint":
        os.makedirs(path, exist_ok=True)
        ckpt_format.save_pytree(tree, path, use_orbax=use_orbax)
        return cls(path)

    def load_pytree(self, use_orbax: bool = False,
                    placement: Optional[Callable] = None) -> Any:
        """The checkpoint's tree of CPU tensors (``placement`` reshards a
        sharded checkpoint on the fly)."""
        if placement is not None:
            return ckpt_format.restore_tree(self.path, placement=placement)
        return ckpt_format.load_pytree(self.path, use_orbax=use_orbax)

    def manifest(self) -> Optional[Dict[str, Any]]:
        try:
            return ckpt_format.read_manifest(self.path)
        except (FileNotFoundError, ckpt_format.CheckpointError):
            return None

    def validate(self, deep: bool = False) -> List[str]:
        return ckpt_format.verify_checkpoint(self.path, deep=deep)

    def __repr__(self):
        return f"Checkpoint({self.path})"


def atomic_rmtree(path: str) -> None:
    """Delete a directory so no reader can race with a half-deleted tree:
    one atomic rename takes it out of the namespace, then the rename
    target is reaped at leisure."""
    if not os.path.isdir(path):
        return
    doomed = f"{path}.deleting-{os.getpid()}-{time.monotonic_ns()}"
    try:
        os.replace(path, doomed)
    except OSError:
        # Concurrent deleter won the rename; nothing left to do.
        return
    shutil.rmtree(doomed, ignore_errors=True)


class CheckpointManager:
    """Tracks committed checkpoints under <storage>/<experiment>/.

    Commit protocol, sharded path: per-rank acks land via ``note_ack``;
    ``commit_ready()`` writes the manifest once a step has a full ack set
    (coordinator-side; reference analog: checkpoint_manager.py
    rank-0-commit, upgraded to all-rank barrier + atomic manifest).
    The legacy path (``register`` from a rank-0 report) still works.
    """

    def __init__(self, storage_path: str, experiment_name: str,
                 num_to_keep: Optional[int] = None):
        self.root = os.path.normpath(
            os.path.join(os.path.abspath(storage_path), experiment_name))
        os.makedirs(self.root, exist_ok=True)
        self.num_to_keep = num_to_keep
        self._index_path = os.path.join(self.root, "checkpoints.json")
        self._entries: List[Dict[str, Any]] = []
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                self._entries = json.load(f)
        #: step -> {rank -> ack payload} for the sharded commit protocol.
        self._acks: Dict[int, Dict[int, Dict[str, Any]]] = {}
        self._committed: set = set()
        self._failed_steps: set = set()
        #: Current worker-group generation; acks tagged with another
        #: generation are ignored (set via reset_pending_acks).
        self._generation: Optional[int] = None
        for e in self._entries:
            if e.get("step") is not None:
                self._committed.add(int(e["step"]))

    def checkpoint_dir(self, step: int) -> str:
        return step_dir(self.root, step)

    # -- sharded commit protocol -------------------------------------------

    def note_ack(self, payload: Dict[str, Any]) -> None:
        step = int(payload["step"])
        if step in self._committed:
            return
        # A dead group's straggler ack (its writer thread raced the
        # teardown) must not join the current generation's ack set.
        gen = payload.get("generation")
        if gen is not None and self._generation is not None and \
                gen != self._generation:
            return
        self._acks.setdefault(step, {})[int(payload["rank"])] = payload

    def reset_pending_acks(self, generation: Optional[int] = None) -> None:
        """Drop every uncommitted ack set.  Called on group re-formation
        (failure recovery / elastic resize): a retried step must commit
        only from a COMPLETE ack set of the new incarnation — mixing a
        dead incarnation's acks with the new one's would commit a
        manifest spanning two divergent training timelines (and race the
        new incarnation's in-flight shard rewrites)."""
        self._acks.clear()
        self._failed_steps.clear()
        self._generation = generation

    def commit_ready(self) -> List[Dict[str, Any]]:
        """Commit every step whose full ack set has arrived; returns the
        freshly committed manifests (in step order)."""
        out: List[Dict[str, Any]] = []
        for step in sorted(self._acks):
            if step in self._committed or step in self._failed_steps:
                continue
            acks = self._acks[step]
            world = int(next(iter(acks.values()))["world"])
            if len(acks) < world:
                continue
            dirpath = acks[min(acks)]["dir"]
            rank0 = acks.get(0, {})
            # Manifest metrics must be JSON-clean: a 0-d tensor or numpy
            # scalar (a loss) would raise out of json.dumps.
            metrics = _scalar_metrics(rank0.get("metrics") or {})
            try:
                manifest = ckpt_format.build_manifest(
                    dirpath, step, world, metrics=metrics,
                    replica=any(a.get("replica") for a in acks.values()))
                ckpt_format.commit_manifest(dirpath, manifest)
            except Exception as e:  # noqa: BLE001 — a commit failure
                # must fail the STEP, never the training run.  The step
                # stays invisible to latest() and is GC'd later.
                telemetry.note_swallowed("checkpoint.commit", e)
                self._failed_steps.add(step)
                continue
            self._committed.add(step)
            self._register_entry({
                "path": os.path.abspath(dirpath),
                "metrics": metrics,
                "time": time.time(),
                "step": step,
                "world_size": world,
                "total_bytes": manifest["total_bytes"],
                "replica": manifest["replica"],
            })
            out.append(manifest)
        if out:
            self.gc_uncommitted()
            for step in list(self._acks):
                if step in self._committed:
                    del self._acks[step]
        return out

    def gc_uncommitted(self) -> List[str]:
        """Reap checkpoint dirs that can no longer commit: older than the
        newest committed step, no manifest, not registered.  Newer
        uncommitted dirs are in-flight saves and must be left alone."""
        if not self._committed:
            return []
        horizon = max(self._committed)
        known = {e["path"] for e in self._entries}
        reaped: List[str] = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        for name in names:
            step = _dir_step(name)
            path = os.path.join(self.root, name)
            if step is None or step >= horizon or path in known:
                continue
            if ckpt_format.is_committed(path):
                continue
            atomic_rmtree(path)
            reaped.append(path)
        return reaped

    # -- legacy commit (rank-0 report) --------------------------------------

    def register(self, path: str, metrics: Dict[str, Any]) -> None:
        self._register_entry({
            "path": os.path.abspath(path),
            "metrics": _scalar_metrics(metrics),
            "time": time.time(),
        })

    def _register_entry(self, entry: Dict[str, Any]) -> None:
        self._entries.append(entry)
        self._flush()
        self._enforce_retention()

    # -- queries ------------------------------------------------------------

    def latest(self) -> Optional[str]:
        return self._entries[-1]["path"] if self._entries else None

    def best(self, metric: str, mode: str = "min") -> Optional[str]:
        scored = [e for e in self._entries if metric in e["metrics"]]
        if not scored:
            return None
        pick = min if mode == "min" else max
        return pick(scored, key=lambda e: e["metrics"][metric])["path"]

    def all_entries(self) -> List[Dict[str, Any]]:
        return list(self._entries)

    def _flush(self) -> None:
        ckpt_format.write_bytes_atomic(
            self._index_path, json.dumps(self._entries, indent=1).encode())

    def _enforce_retention(self) -> None:
        if not self.num_to_keep:
            return
        while len(self._entries) > self.num_to_keep:
            victim = self._entries.pop(0)
            self._flush()
            atomic_rmtree(victim["path"])


def _scalar_metrics(metrics: Dict[str, Any]) -> Dict[str, Any]:
    """JSON-safe scalar subset of user metrics (numpy scalars coerced:
    np.float32 is not a python float and would crash json.dumps)."""
    out: Dict[str, Any] = {}
    for k, v in metrics.items():
        if isinstance(v, bool) or isinstance(v, (str,)):
            out[k] = v
        elif isinstance(v, (int, float)):
            out[k] = v
        elif hasattr(v, "item") and getattr(v, "shape", None) in ((), None):
            try:
                item = v.item()
            except Exception:
                continue
            if isinstance(item, (int, float, bool, str)):
                out[k] = item
    return out


def scan_run_dir(root: str, deep: bool = False) -> List[Dict[str, Any]]:
    """Filesystem view of a run directory for ``ray-tpu ckpt ls``: every
    ``checkpoint_*`` dir with step, size, shard count, replica presence
    and validity — committed or not."""
    out: List[Dict[str, Any]] = []
    try:
        # Numeric step order, not lexicographic: zero-padding overflows
        # past step 999999 and would mis-sort "newest".
        names = sorted(os.listdir(root),
                       key=lambda n: (_dir_step(n) is None,
                                      _dir_step(n) or 0, n))
    except OSError as e:
        raise ckpt_format.CheckpointError(f"cannot list {root}: {e}")
    for name in names:
        step = _dir_step(name)
        if step is None:
            continue
        path = os.path.join(root, name)
        if not os.path.isdir(path):
            continue
        rec: Dict[str, Any] = {"path": path, "step": step}
        problems = ckpt_format.verify_checkpoint(path, deep=deep)
        committed = ckpt_format.is_committed(path)
        rec["committed"] = committed
        rec["valid"] = committed and not problems
        rec["problems"] = problems
        manifest = None
        if committed:
            try:
                manifest = ckpt_format.read_manifest(path)
            except ckpt_format.CheckpointError:
                manifest = None
        if manifest is not None:
            rec.update(shards=len(manifest["shards"]),
                       world_size=manifest["world_size"],
                       bytes=manifest["total_bytes"],
                       replica=manifest["replica"],
                       time=manifest["time"],
                       metrics=manifest.get("metrics", {}))
        else:
            rec.update(shards=sum(
                1 for f in os.listdir(path) if f.endswith(".index.json")),
                bytes=sum(os.path.getsize(os.path.join(path, f))
                          for f in os.listdir(path)
                          if f.endswith(".bin")),
                replica=False)
        out.append(rec)
    return out


# -- worker-side save client -------------------------------------------------


class WorkerCheckpointClient:
    """Per-train-worker save/restore client (owned by the TrainContext)."""

    def __init__(self, run_id: str, rank: int, world_size: int,
                 run_root: str, experiment: str,
                 async_save: bool = True, max_inflight: int = 2,
                 emergency_replica: bool = False,
                 initial_step: int = 0,
                 generation: Optional[int] = None):
        self.run_id = run_id
        self.rank = rank
        self.world_size = world_size
        self.run_root = run_root
        self.experiment = experiment
        self.async_save = async_save
        self.generation = generation
        if emergency_replica:
            raise NotImplementedError(EMERGENCY_REPLICA_TODO)
        self._writer: Optional[AsyncCheckpointWriter] = None
        self._max_inflight = max_inflight
        # Auto-step sequence: a restarted worker resumes PAST the
        # checkpoint it restored from, never over it.
        self._step_seq = initial_step
        # Incarnation nonce: scopes ack keys to THIS worker process, so
        # recovery restarts can't alias them.
        import uuid as _uuid
        self._nonce = _uuid.uuid4().hex[:8]

    # -- save ----------------------------------------------------------------

    def save(self, tree: Any, metrics: Optional[Dict[str, Any]] = None,
             shard_spec: Optional[Callable] = None,
             step: Optional[int] = None,
             sync: Optional[bool] = None) -> str:
        """Checkpoint this rank's shards of ``tree``; returns the
        checkpoint directory.  Blocking work: device->host snapshot (+
        queue backpressure).  The checkpoint only becomes ``latest`` once
        the coordinator has every rank's ack and commits the manifest."""
        if step is None:
            step = self._step_seq
        self._step_seq = step + 1
        dirpath = step_dir(self.run_root, step)
        if ckpt_format.is_committed(dirpath):
            # An explicit user step colliding with a committed checkpoint
            # would atomically replace its shard files underneath the
            # manifest — corrupting "latest" with no way to re-commit
            # (the coordinator ignores acks for committed steps).
            raise ckpt_format.CheckpointError(
                f"step {step} is already a committed checkpoint "
                f"({dirpath}); resume PAST a restored checkpoint, never "
                f"over it")
        use_sync = (not self.async_save) if sync is None else sync
        if use_sync and self._writer is not None:
            # A sync save implies every earlier async save of this rank
            # has landed: without the barrier, committing THIS step could
            # let the coordinator's GC reap an older step's directory
            # while the writer is still publishing into it.
            self.flush()

        t0 = time.monotonic()
        snapshot = ckpt_format.snapshot_tree(tree, shard_spec=shard_spec)
        blocking_s = time.monotonic() - t0
        job = WriteJob(dirpath=dirpath, step=step, rank=self.rank,
                       world=self.world_size, snapshot=snapshot,
                       on_done=self._make_on_done(metrics))
        if use_sync:
            t1 = time.monotonic()
            publish_shard(job)
            blocking_s += time.monotonic() - t1
        else:
            blocking_s += self._ensure_writer().submit(job)
        telemetry.observe("ray_tpu_ckpt_save_blocking_seconds", blocking_s)
        # Goodput: only the BLOCKING slice of the save stole step time;
        # the controller reattributes it out of the "step" phase.
        telemetry.note_checkpoint_seconds(blocking_s)
        return dirpath

    def _ensure_writer(self) -> AsyncCheckpointWriter:
        if self._writer is None:
            self._writer = AsyncCheckpointWriter(
                max_inflight=self._max_inflight)
        return self._writer

    def _make_on_done(self, metrics: Optional[Dict[str, Any]]):
        def on_done(job: WriteJob, index: Dict[str, Any], blob: bytes,
                    write_s: float) -> None:
            self._ack(job, index, blob, write_s, metrics)
        return on_done

    def _ack(self, job: WriteJob, index: Dict[str, Any], blob: bytes,
             write_s: float, metrics: Optional[Dict[str, Any]]) -> None:
        from .._control import _control
        payload = {
            "step": job.step, "rank": job.rank, "world": job.world,
            "dir": job.dirpath, "nbytes": len(blob),
            "crc32": index["crc32"], "write_s": write_s,
            "replica": False, "metrics": dict(metrics or {}),
            "generation": self.generation,
        }
        _control("kv_put",
                 ack_key(self.run_id, job.step, job.rank, self._nonce),
                 pickle.dumps(payload))

    # -- restore -------------------------------------------------------------

    def load(self, path: str,
             placement: Optional[Callable] = None) -> Any:
        """Restore from a committed checkpoint (or a legacy pickle when no
        placement is asked for)."""
        t0 = time.monotonic()
        if not ckpt_format.is_committed(path):
            if placement is not None:
                raise ckpt_format.CheckpointError(
                    f"{path} is a legacy single-pickle checkpoint: it "
                    f"has no shard index, so a resharding placement "
                    f"cannot be honored")
            # Legacy pickle layout.
            out = ckpt_format.load_pytree(path)
            return out
        tree = ckpt_format.restore_tree(path, placement=placement)
        telemetry.observe("ray_tpu_ckpt_restore_seconds",
                          time.monotonic() - t0, tags={"source": "disk"})
        return tree

    # -- lifecycle -----------------------------------------------------------

    def flush(self, timeout: Optional[float] = 120.0) -> None:
        if self._writer is None:
            return
        drained = self._writer.wait_idle(timeout)
        self._writer.raise_on_error()
        if not drained:
            # No write ERROR, but the durability guarantee the caller
            # asked for was not met — that must be loud too.
            raise ckpt_format.CheckpointError(
                f"checkpoint writer did not drain within {timeout}s")

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None
