"""Background checkpoint writer: serialize + write off the train step path
(a copy of ray_tpu/checkpoint/async_writer.py over the port's format).

The contract with the caller (``manager.WorkerCheckpointClient``): the only
blocking work in a save is snapshotting tensors to host copies that own their bytes and, if
the bounded in-flight queue is full, waiting for a slot (backpressure — a
saver that outruns the disk must not buffer unbounded host copies).
Everything else — building the shard blob, the tmp+rename publish, the
replica push, the coordinator ack — happens on this thread while the next
train steps run.

Failure semantics: a failed write marks the job failed and NEVER acks, so
the coordinator never commits a manifest over it; the error surfaces on the
next ``raise_on_error()`` / ``close()`` so the train loop notices instead of
silently training past unlanded checkpoints.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from ..util import telemetry
from . import format as ckpt_format

#: Test hook: sleep this many seconds before each shard write (lets chaos
#: tests kill a worker reliably mid-async-save).
_WRITE_DELAY_ENV = "RAY_TPU_CKPT_TEST_WRITE_DELAY_S"


@dataclass
class WriteJob:
    dirpath: str
    step: int
    rank: int
    world: int
    snapshot: ckpt_format.Snapshot
    #: Called on the writer thread after a successful publish with
    #: (job, index, blob, write_seconds); acks/replica pushes live here.
    on_done: Optional[Callable] = None
    enqueued_mono: float = field(default_factory=time.monotonic)


class AsyncCheckpointWriter:
    """One writer thread + a bounded in-flight queue per worker process."""

    def __init__(self, max_inflight: int = 2):
        self.max_inflight = max(1, int(max_inflight))
        self._q: "queue.Queue[Optional[WriteJob]]" = queue.Queue(
            maxsize=self.max_inflight)
        self._errors: List[BaseException] = []
        self._err_lock = threading.Lock()
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._idle = threading.Condition(self._inflight_lock)
        self._thread = threading.Thread(
            target=self._run, name="ckpt-writer", daemon=True)
        self._thread.start()
        self._closed = False

    # -- producer side (train thread) ---------------------------------------

    def submit(self, job: WriteJob) -> float:
        """Enqueue a write; returns seconds spent blocked on backpressure."""
        if self._closed:
            raise RuntimeError("writer is closed")
        self.raise_on_error()
        t0 = time.monotonic()
        with self._inflight_lock:
            self._inflight += 1
        self._gauge()
        self._q.put(job)
        return time.monotonic() - t0

    def raise_on_error(self) -> None:
        """Surface the oldest pending write error ONCE.

        The error is popped as it raises: a transient disk failure must
        not poison every later save for the rest of the run — the caller
        that caught the error keeps checkpointing, and the failed step
        simply never acked (so it can never be committed)."""
        with self._err_lock:
            if not self._errors:
                return
            err = self._errors.pop(0)
        raise ckpt_format.CheckpointError(
            f"async checkpoint write failed: {err!r}") from err

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        """Block until every submitted write has published (or failed)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._idle:
            while self._inflight > 0:
                remaining = None if deadline is None else \
                    max(0.0, deadline - time.monotonic())
                if deadline is not None and remaining <= 0:
                    return False
                self._idle.wait(remaining if remaining is not None else 1.0)
        return True

    def close(self, timeout: Optional[float] = 120.0) -> None:
        """Flush outstanding writes, stop the thread, surface any error.

        Shutdown is BOUNDED: if the writer is wedged past ``timeout``
        (hung filesystem), the still-queued jobs are dropped — they never
        acked, so the coordinator never commits them — and the failure
        surfaces as a CheckpointError instead of hanging the rank at
        train-fn exit forever.
        """
        if self._closed:
            return
        self._closed = True
        drained = self.wait_idle(timeout)
        if not drained:
            # Wedged writer: make room for the sentinel by dropping the
            # jobs that never started (each is an unlanded, uncommitted
            # save) and record the condition as an error.
            dropped = 0
            while True:
                try:
                    job = self._q.get_nowait()
                except queue.Empty:
                    break
                if job is None:
                    continue
                dropped += 1
                with self._inflight_lock:
                    self._inflight -= 1
                    self._idle.notify_all()
            with self._err_lock:
                self._errors.append(ckpt_format.CheckpointError(
                    f"writer did not drain within {timeout}s at close "
                    f"({dropped} queued save(s) dropped, one write still "
                    f"wedged)"))
            self._gauge()
        try:
            self._q.put_nowait(None)
        except queue.Full:
            pass  # writer wedged mid-job with a refilled queue: daemon
            # thread dies with the process; nothing more to flush.
        self._thread.join(timeout=10.0)
        self.raise_on_error()

    @property
    def inflight(self) -> int:
        with self._inflight_lock:
            return self._inflight

    # -- writer thread -------------------------------------------------------

    def _run(self) -> None:
        while True:
            try:
                # Bounded get, not a blocking one: when close() timed
                # out on a wedged write it may fail to enqueue the None
                # sentinel (a producer raced the queue slot) — the
                # closed-flag check below still retires this thread once
                # the wedged job finishes, instead of leaking it for the
                # rest of the process (leak found by the sanitizer).
                job = self._q.get(timeout=0.5)
            except queue.Empty:
                if self._closed:
                    return
                continue
            if job is None:
                return
            try:
                self._write_one(job)
            except BaseException as e:  # noqa: BLE001 — surfaced to producer
                with self._err_lock:
                    self._errors.append(e)
                telemetry.note_swallowed("checkpoint.async_writer", e)
            finally:
                with self._inflight_lock:
                    self._inflight -= 1
                    self._idle.notify_all()
                self._gauge()

    def _write_one(self, job: WriteJob) -> None:
        publish_shard(job)

    def _gauge(self) -> None:
        telemetry.set_gauge("ray_tpu_ckpt_inflight", float(self.inflight))


def publish_shard(job: WriteJob) -> None:
    """Serialize + publish one shard and run its callback — THE write
    path, shared by the writer thread and synchronous saves (so the
    telemetry, the chaos delay hook, and any future change to the
    publish sequence stay identical in both modes)."""
    delay = float(os.environ.get(_WRITE_DELAY_ENV, "0") or 0)
    if delay > 0:
        time.sleep(delay)
    t0 = time.monotonic()
    index, blob = ckpt_format.build_shard(
        job.snapshot, job.rank, job.world, job.step)
    ckpt_format.write_shard(
        job.dirpath, index, blob,
        skeleton_pkl=job.snapshot.skeleton_pkl if job.rank == 0 else None)
    write_s = time.monotonic() - t0
    telemetry.observe("ray_tpu_ckpt_write_seconds", write_s)
    telemetry.inc("ray_tpu_ckpt_bytes_total", len(blob))
    if job.on_done is not None:
        job.on_done(job, index, blob, write_s)
