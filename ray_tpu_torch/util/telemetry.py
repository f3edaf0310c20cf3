"""Built-in telemetry of the train and serving paths (a copy of the part of
ray_tpu/util/telemetry.py that the train runtime, the engine, the disagg
tier and the fleet call, with its metric names).

- ``CATALOG`` declares every metric the train runtime and the checkpoint
  subsystem record (``ray_tpu_train_*``, ``ray_tpu_ckpt_*``), those the
  engine, the disagg tier and the fleet record (``ray_tpu_llm_*``,
  ``ray_tpu_serve_*``), the host-sync tripwire's and the recompile
  detector's (``ray_tpu_jax_host_sync_*``, ``ray_tpu_profiler_*``), the
  data executor's (``ray_tpu_data_*``), and the swallowed-error counter.
  ``inc``/``observe``/``set_gauge`` record into this process's registry
  and never raise (an undeclared name records nothing, as JAX's helpers
  swallow it).
- Worker processes ship ``snapshot()`` to the controller when their train
  fn ends (a task worker, with each task's result); the controller keeps
  them by source (``merge_remote``), and
  ``samples``/``emitted_names`` read the merged view, as JAX's scrape
  merges every worker's pushed snapshot.
- ``profile_span``/``_emit_span`` record finished spans in a bounded
  in-process buffer (``spans()``).
- ``GoodputTracker`` (a copy) partitions a run's wall time into phases and
  keeps ``ray_tpu_train_goodput_ratio`` current.
"""

from __future__ import annotations

import collections
import copy
import logging
import threading
import time
from typing import Any, Dict, Optional, Tuple

_LATENCY_BUCKETS = [0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5,
                    1.0, 2.5, 5.0, 10.0, 30.0, 60.0]
_SIZE_BUCKETS = [1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0]
_STEP_BUCKETS = [0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 30.0, 60.0,
                 120.0, 300.0, 600.0]


def _h(tags, description, boundaries=_STEP_BUCKETS):
    return {"type": "histogram", "tag_keys": tags,
            "boundaries": boundaries, "description": description}


def _c(tags, description):
    return {"type": "counter", "tag_keys": tags, "description": description}


def _g(tags, description):
    return {"type": "gauge", "tag_keys": tags, "description": description}


#: name -> {"type", "tag_keys", "description", "boundaries"?}
CATALOG: Dict[str, Dict[str, Any]] = {
    "ray_tpu_train_step_seconds": _h(
        (), "Wall time between consecutive rank-0 train.report() calls "
            "(one reporting step)."),
    "ray_tpu_train_tokens_total": _c(
        (), "Training tokens, from report() metrics carrying a tokens/"
            "num_tokens/tokens_per_step key."),
    "ray_tpu_train_reports_total": _c(
        (), "train.report() calls across all ranks."),
    "ray_tpu_train_checkpoint_seconds": _h(
        ("op",), "Checkpoint pytree save/restore duration "
                 "(op=save|restore)."),
    "ray_tpu_train_worker_restarts_total": _c(
        (), "Train workers torn down and restarted after a failure."),
    "ray_tpu_train_urgent_ckpt_total": _c(
        (), "Urgent checkpoint flushes triggered by a drain notice."),
    "ray_tpu_train_restart_backoff_seconds": _h(
        (), "Backoff slept between group re-formations after a failure."),
    "ray_tpu_train_goodput_ratio": _g(
        (), "Productive-step wall time over total run wall time."),
    "ray_tpu_train_step_phase_seconds": _h(
        ("phase",), "Seconds each reporting step spent in a declared "
                    "phase (data_wait|h2d|compute|collective|ckpt_block|"
                    "other)."),
    "ray_tpu_train_hbm_used_bytes": _g(
        ("device",), "Per-device accelerator memory in use."),
    "ray_tpu_train_hbm_peak_bytes": _g(
        ("device",), "Per-device peak accelerator memory since process "
                     "start."),
    "ray_tpu_train_straggler_total": _c(
        (), "Watchdog straggler verdicts (one per incident)."),
    "ray_tpu_train_hang_total": _c(
        (), "Watchdog hang verdicts (one per incident)."),
    "ray_tpu_train_mesh_axis_size": _g(
        ("axis",), "Live SPMD mesh axis sizes of the current train worker "
                   "group."),
    "ray_tpu_train_param_shard_bytes": _g(
        (), "This process's parameter-shard bytes after train.shard() / a "
            "mesh restore."),
    "ray_tpu_train_upsize_total": _c(
        (), "Elastic upsizes of the worker group."),
    "ray_tpu_train_mesh_reshapes_total": _c(
        (), "Mesh reshape events: a group re-formed at another mesh shape, "
            "or a checkpoint restored onto a mesh other than the saver's."),
    "ray_tpu_ckpt_save_blocking_seconds": _h(
        (), "Train-thread time a save stole: the device->host snapshot "
            "plus write-queue backpressure (async) or the whole write "
            "(sync)."),
    "ray_tpu_ckpt_write_seconds": _h(
        (), "Background shard serialize+publish duration."),
    "ray_tpu_ckpt_bytes_total": _c(
        (), "Checkpoint shard bytes published by this process."),
    "ray_tpu_ckpt_inflight": _g(
        (), "Async checkpoint saves queued or writing."),
    "ray_tpu_ckpt_restore_seconds": _h(
        ("source",), "Checkpoint restore duration, by shard source "
                     "(source=disk|replica)."),
    "ray_tpu_ckpt_replica_restores_total": _c(
        (), "Restores that used in-memory emergency replica shards."),
    # -- serve: deployments (serve/api) -----------------------------------
    "ray_tpu_serve_requests_total": _c(
        ("deployment",), "Requests routed to a deployment replica."),
    "ray_tpu_serve_request_errors_total": _c(
        ("deployment",), "Requests that raised at the ingress/handle "
                         "layer."),
    "ray_tpu_serve_request_latency_seconds": _h(
        ("deployment",), "End-to-end handle request latency (route -> "
                         "result materialized).", _LATENCY_BUCKETS),
    "ray_tpu_serve_queue_wait_seconds": _h(
        ("method",), "Time a @serve.batch item waited in the queue "
                     "before its batch started executing.",
        _LATENCY_BUCKETS),
    "ray_tpu_serve_batch_size": _h(
        ("method",), "Items per executed @serve.batch batch.",
        _SIZE_BUCKETS),
    "ray_tpu_serve_replicas": _g(
        ("deployment",), "Live replica count per deployment (controller "
                         "view)."),
    "ray_tpu_serve_ongoing_requests": _g(
        ("deployment",), "This process's in-flight requests per "
                         "deployment (router view)."),
    "ray_tpu_serve_shed_total": _c(
        ("deployment",), "Handle-path requests rejected by the "
                         "max_queued_requests admission bound (retriable "
                         "OverloadError)."),
    # -- serve: decode fleet (llm/fleet) ----------------------------------
    "ray_tpu_serve_replica_count": _g(
        ("fleet",), "Accepting decode replicas in a serving fleet "
                    "(FleetServer view; draining/dead excluded)."),
    "ray_tpu_serve_prefix_hit_total": _c(
        ("outcome",), "Fleet routing outcomes per dispatched request: "
                      "full (exact prompt cached, prefill skipped), "
                      "partial (prefix overlap steered placement), miss "
                      "(load-only placement)."),
    "ray_tpu_serve_rebalance_total": _c(
        (), "Requests whose prefix affinity was overridden by the "
            "load-imbalance watermark (routed by load instead of cache "
            "locality)."),
    "ray_tpu_serve_replica_scale_total": _c(
        ("direction",), "Fleet replica scale actions (up = spawn/"
                        "backfill, down = drain-then-remove), autoscaler "
                        "or manual."),
    # -- llm (engine, disagg tier) -----------------------------------------
    "ray_tpu_llm_ttft_seconds": _h(
        (), "Time to first token: request add -> first output token "
            "sampled (includes queueing + prefill).", _LATENCY_BUCKETS),
    "ray_tpu_llm_decode_token_seconds": _h(
        (), "Per-token decode latency (batched step wall time; chunked "
            "steps attribute wall/steps per token).", _LATENCY_BUCKETS),
    "ray_tpu_llm_tokens_total": _c(
        ("kind",), "Tokens processed by the engine (kind=prompt|decode)."),
    "ray_tpu_llm_kv_page_occupancy": _g(
        (), "Fraction of KV-cache pages allocated (0..1)."),
    "ray_tpu_llm_active_slots": _g(
        (), "Decode slots with a running request."),
    "ray_tpu_llm_requests_finished_total": _c(
        ("reason",), "Engine requests finished, by finish_reason (stop|"
                     "length|prompt_too_long|kv_capacity_exceeded|"
                     "cancelled)."),
    "ray_tpu_llm_preemptions_total": _c(
        (), "Requests evicted mid-flight (cancel/timeout releasing an "
            "occupied slot, or recompute preemption under KV pressure)."),
    "ray_tpu_llm_waiting_requests": _g(
        (), "Requests queued for admission (KV/slot backpressure "
            "depth)."),
    "ray_tpu_llm_admission_queue_depth": _g(
        ("class",), "Requests held in the SLO router's bounded admission "
                    "queue, per request class (disagg router; ahead of "
                    "engine admission)."),
    "ray_tpu_llm_shed_total": _c(
        ("reason",), "Requests shed by SLO-aware admission control "
                     "(reason=queue_full|class_budget|backpressure|"
                     "deadline|deadline_infeasible|replica_lost).  "
                     "Shedding is a retriable overload error, never a "
                     "silent timeout."),
    "ray_tpu_llm_kv_transfer_bytes_total": _c(
        (), "KV-cache bytes handed off from prefill to decode workers "
            "(disagg page-blob transfers)."),
    "ray_tpu_llm_kv_transfer_seconds": _h(
        ("op",), "Prefill->decode KV handoff latency (op=export|import: "
                 "object-store publish / decode-side page scatter).",
        _LATENCY_BUCKETS),
    "ray_tpu_llm_prefill_chunks_total": _c(
        (), "Chunked-prefill chunks executed (single-engine disagg-off "
            "fallback: long prompts sliced across decode steps)."),
    "ray_tpu_jax_host_sync_total": _c(
        ("site",), "Implicit CUDA tensor device->host syncs by call site "
                   "(float()/.item()/.tolist()/np.asarray() on a CUDA "
                   "tensor), from the opt-in tripwire "
                   "(RAY_TPU_SYNC_DEBUG=1; JAX's name, so one query reads "
                   "either package).  Published in batches of 64 per "
                   "site; a hot site in a step/decode loop is an RT502 to "
                   "fix."),
    "ray_tpu_jax_host_sync_seconds": _h(
        ("site",), "Sampled blocked time of implicit CUDA tensor "
                   "device->host syncs by call site (~1/64th of syncs), "
                   "from the opt-in tripwire.", _LATENCY_BUCKETS),
    "ray_tpu_profiler_compile_total": _c(
        ("fn",), "Kernel builds/loads and first launches of a new launch "
                 "shape attributed to a tracked call site (the port's "
                 "counterpart of an XLA compile; fn=<site name>)."),
    "ray_tpu_profiler_compile_seconds": _h(
        ("fn",), "Seconds spent building/loading kernel libraries and "
                 "preparing first launches per tracked call site."),
    "ray_tpu_profiler_recompiles_total": _c(
        ("fn",), "POST-WARMUP builds or first launches: a tracked site "
                 "that had reached steady state met a new launch shape "
                 "(shape churn).  Each also logs a once-per-site warning "
                 "naming the offending shapes."),
    "ray_tpu_internal_swallowed_errors_total": _c(
        ("where",), "Control-plane exceptions intentionally swallowed "
                    "(best-effort paths), by call site."),
    # -- locks (devtools/lockdebug's contention profiler) -----------------
    "ray_tpu_lock_wait_seconds": _h(
        ("site",), "Sampled lock-acquire wait by creation site (~1/64th "
                   "of releases), from the opt-in contention profiler "
                   "(RAY_TPU_LOCK_PROFILE=1 / RAY_TPU_DEBUG_LOCKS=1).",
        _LATENCY_BUCKETS),
    "ray_tpu_lock_hold_seconds": _h(
        ("site",), "Sampled lock hold time by creation site (~1/64th of "
                   "releases), from the opt-in contention profiler.",
        _LATENCY_BUCKETS),
    # -- data (the streaming executor; recorded in the task workers) ------
    "ray_tpu_data_block_seconds": _h(
        ("operator",), "Per-block processing time in the streaming "
                       "executor (operator=map|reduce).",
        _LATENCY_BUCKETS),
    "ray_tpu_data_rows_total": _c(
        ("operator",), "Rows produced by data-pipeline operators."),
    "ray_tpu_data_blocks_total": _c(
        ("operator",), "Blocks processed by data-pipeline operators."),
    # -- the scheduler (``_scheduler.py``) and elastic training ------------
    "ray_tpu_sched_decisions_total": _c(
        ("kind",), "Scheduler decisions by kind (inline|loop|exchange|"
                   "pipeline|reject|infeasible|pg_commit|pg_reject)."),
    "ray_tpu_sched_placement_attempts": _h(
        (), "Placement rounds a task needed before it was placed.",
        _SIZE_BUCKETS),
    "ray_tpu_sched_pg_commit_seconds": _h(
        (), "Placement-group two-phase commit latency: create (or the "
            "re-plan after a node death) to CREATED.", _LATENCY_BUCKETS),
    "ray_tpu_sched_queue_depth": _g(
        ("queue",), "Scheduler queue depths (queue=ready|waiting_deps|"
                    "infeasible|pending_pgs), refreshed about once a "
                    "second."),
    "ray_tpu_train_upsize_total": _c(
        (), "Elastic upsizes: the worker group tore down at a checkpoint "
            "boundary and re-formed larger because capacity joined."),
}

_lock = threading.Lock()
#: name -> {tags key -> [tags, value]} (histograms: [tags, count, sum,
#: bucket counts]).
_local: Dict[str, Dict[Tuple, list]] = {}
#: source id -> a worker's ``snapshot()``.
_remote: Dict[str, Dict[str, Dict[Tuple, list]]] = {}


def _record(name: str, kind: str, value: float,
            tags: Optional[Dict[str, str]]) -> None:
    spec = CATALOG.get(name)
    if spec is None or spec["type"] != kind:
        return
    tags = {k: str(v) for k, v in (tags or {}).items()}
    key = tuple(sorted(tags.items()))
    with _lock:
        series = _local.setdefault(name, {})
        if kind == "histogram":
            bounds = spec["boundaries"]
            cur = series.setdefault(key, [tags, 0, 0.0, [0] * (len(bounds)
                                                               + 1)])
            cur[1] += 1
            cur[2] += float(value)
            cur[3][sum(1 for b in bounds if value > b)] += 1
        elif kind == "counter":
            cur = series.setdefault(key, [tags, 0.0])
            cur[1] += float(value)
        else:
            series[key] = [tags, float(value)]


def inc(name: str, value: float = 1.0,
        tags: Optional[Dict[str, str]] = None) -> None:
    _record(name, "counter", value, tags)


def observe(name: str, value: float,
            tags: Optional[Dict[str, str]] = None) -> None:
    _record(name, "histogram", value, tags)


def observe_many(name: str, values,
                 tags: Optional[Dict[str, str]] = None) -> None:
    """``observe`` each of ``values`` (the scheduler's attempt-sample
    flush)."""
    for v in values:
        _record(name, "histogram", v, tags)


def set_gauge(name: str, value: float,
              tags: Optional[Dict[str, str]] = None) -> None:
    _record(name, "gauge", value, tags)


def note_swallowed(where: str, exc: Optional[BaseException] = None) -> None:
    """Account for an intentionally swallowed exception: a debug-log line
    and ``ray_tpu_internal_swallowed_errors_total{where}``."""
    inc("ray_tpu_internal_swallowed_errors_total", tags={"where": where})
    logging.getLogger("ray_tpu_torch").debug(
        "swallowed error in %s: %r", where, exc)


def snapshot() -> Dict[str, Dict[Tuple, list]]:
    """This process's series (picklable), for the controller's merge."""
    with _lock:
        return copy.deepcopy(_local)


def merge_remote(source: str, snap: Dict[str, Dict[Tuple, list]]) -> None:
    """Keep a worker's latest snapshot under ``source``."""
    with _lock:
        _remote[source] = snap


def samples(name: str) -> Dict[Tuple, list]:
    """Series of ``name`` merged over this process and every worker
    snapshot: counters and histograms summed, gauges the last writer's."""
    kind = CATALOG.get(name, {}).get("type")
    out: Dict[Tuple, list] = {}
    with _lock:
        sources = [_local] + list(_remote.values())
        for src in sources:
            for key, val in src.get(name, {}).items():
                if key not in out or kind == "gauge":
                    out[key] = copy.deepcopy(val)
                elif kind == "counter":
                    out[key][1] += val[1]
                else:
                    out[key][1] += val[1]
                    out[key][2] += val[2]
                    out[key][3] = [a + b for a, b in zip(out[key][3],
                                                         val[3])]
    return out


def emitted_names() -> set:
    """Names with at least one series, merged over every source."""
    with _lock:
        sources = [_local] + list(_remote.values())
        return {n for src in sources for n, s in src.items() if s}


_instances_lock = threading.Lock()
_instances: Dict[str, Any] = {}


def _get(name: str, expect_type: str):
    """The catalog series ``name`` as a ``util.metrics`` instance (one per
    name), for code that holds a metric object, as JAX's ``counter``/
    ``gauge``/``histogram`` give it.  The framework's own call sites
    record through ``inc``/``observe``/``set_gauge`` into this module's
    registry, which ``samples`` reads; the instances appear in
    ``util.metrics``' Prometheus text."""
    from . import metrics as _metrics
    spec = CATALOG.get(name)
    if spec is None:
        raise KeyError(f"{name!r} is not in the built-in telemetry catalog")
    if spec["type"] != expect_type:
        raise TypeError(f"{name!r} is a {spec['type']}, not a {expect_type}")
    inst = _instances.get(name)
    if inst is not None:
        return inst
    with _instances_lock:
        inst = _instances.get(name)
        if inst is None:
            if spec["type"] == "counter":
                inst = _metrics.Counter(name, spec["description"],
                                        tag_keys=spec["tag_keys"])
            elif spec["type"] == "gauge":
                inst = _metrics.Gauge(name, spec["description"],
                                      tag_keys=spec["tag_keys"])
            else:
                inst = _metrics.Histogram(name, spec["description"],
                                          boundaries=spec.get("boundaries"),
                                          tag_keys=spec["tag_keys"])
            _instances[name] = inst
    return inst


def counter(name: str):
    return _get(name, "counter")


def gauge(name: str):
    return _get(name, "gauge")


def histogram(name: str):
    return _get(name, "histogram")


def _reset_for_tests() -> None:
    global _goodput_latest, _pending_ckpt_s
    with _lock:
        _local.clear()
        _remote.clear()
    with _instances_lock:
        _instances.clear()
    _spans.clear()
    _goodput_latest = None
    _pending_ckpt_s = 0.0


# -- profile spans ---------------------------------------------------------

_spans: "collections.deque" = collections.deque(maxlen=10000)


def _emit_span(name: str, category: str, start_s: float, end_s: float,
               extra: Optional[Dict[str, Any]] = None) -> None:
    """Record one finished span (wall-clock start and end)."""
    _spans.append({"name": name, "category": category, "start": start_s,
                   "end": end_s, "thread": threading.get_ident(),
                   "extra": dict(extra or {})})


def spans() -> list:
    return list(_spans)


class profile_span:
    """Context manager recording its wall time as one span (start
    positioned on the wall clock, length on the monotonic clock)."""

    __slots__ = ("name", "category", "extra", "_frames")

    def __init__(self, name: str, category: str = "system",
                 extra: Optional[Dict[str, Any]] = None):
        self.name = name
        self.category = category
        self.extra = extra
        self._frames: list = []

    def __enter__(self) -> "profile_span":
        self._frames.append((time.time(), time.monotonic()))
        return self

    def __exit__(self, *exc) -> bool:
        start, start_mono = self._frames.pop()
        _emit_span(self.name, self.category, start,
                   start + (time.monotonic() - start_mono), self.extra)
        return False


# -- goodput accounting ----------------------------------------------------

_goodput_latest: Optional["GoodputTracker"] = None

# Checkpoint seconds accrued in THIS process since the last report(): the
# save path notes them, train._context.report() pops them into the report
# payload, and the controller's GoodputTracker reattributes that slice of
# the observed "step" window to the "checkpoint" phase.
_pending_ckpt_lock = threading.Lock()
_pending_ckpt_s = 0.0


def note_checkpoint_seconds(seconds: float) -> None:
    global _pending_ckpt_s
    if seconds > 0:
        with _pending_ckpt_lock:
            _pending_ckpt_s += seconds


def pop_checkpoint_seconds() -> float:
    global _pending_ckpt_s
    with _pending_ckpt_lock:
        s, _pending_ckpt_s = _pending_ckpt_s, 0.0
    return s


class GoodputTracker:
    """Partitions wall time into named phases; goodput = productive/total.

    The productive phase is ``"step"``; everything else (init, restart,
    checkpoint, idle, ...) is overhead.  ``enter(phase)`` switches phase;
    ``reattribute(phase, seconds)`` moves already-elapsed seconds out of
    the current phase (worker-reported checkpoint time that happened
    inside a controller-observed "step" window).  Each transition
    refreshes ``ray_tpu_train_goodput_ratio``."""

    PRODUCTIVE = "step"

    def __init__(self, initial_phase: str = "init",
                 update_gauge: bool = True):
        global _goodput_latest
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self._phase = initial_phase
        self._since = self._t0
        self._finished = False
        self.seconds: Dict[str, float] = {}
        self._update_gauge = update_gauge
        _goodput_latest = self

    def _accumulate_locked(self, now: float) -> None:
        dt = max(0.0, now - self._since)
        self.seconds[self._phase] = self.seconds.get(self._phase, 0.0) + dt
        self._since = now

    def enter(self, phase: str) -> None:
        with self._lock:
            if self._finished:
                return
            self._accumulate_locked(time.monotonic())
            self._phase = phase
        self._refresh_gauge()

    def reattribute(self, phase: str, seconds: float) -> None:
        """Move ``seconds`` of already-elapsed current-phase time into
        ``phase`` (clamped to what the current phase has accrued)."""
        if seconds <= 0:
            return
        with self._lock:
            if self._finished or phase == self._phase:
                return
            self._accumulate_locked(time.monotonic())
            avail = self.seconds.get(self._phase, 0.0)
            moved = min(seconds, avail)
            self.seconds[self._phase] = avail - moved
            self.seconds[phase] = self.seconds.get(phase, 0.0) + moved
        self._refresh_gauge()

    def finish(self) -> Dict[str, Any]:
        with self._lock:
            if not self._finished:
                self._accumulate_locked(time.monotonic())
                self._finished = True
        self._refresh_gauge()
        return self.summary()

    def ratio(self) -> float:
        with self._lock:
            now = time.monotonic()
            open_dt = 0.0 if self._finished else max(0.0, now - self._since)
            total = sum(self.seconds.values()) + open_dt
            productive = self.seconds.get(self.PRODUCTIVE, 0.0) + (
                open_dt if self._phase == self.PRODUCTIVE else 0.0)
        if total <= 0:
            return 0.0
        return productive / total

    def _refresh_gauge(self) -> None:
        if self._update_gauge:
            set_gauge("ray_tpu_train_goodput_ratio", self.ratio())

    def summary(self) -> Dict[str, Any]:
        r = self.ratio()
        with self._lock:
            phases = dict(self.seconds)
            if not self._finished:
                phases[self._phase] = phases.get(self._phase, 0.0) + max(
                    0.0, time.monotonic() - self._since)
        total = sum(phases.values())
        return {"goodput_ratio": r, "total_s": total,
                "productive_s": phases.get(self.PRODUCTIVE, 0.0),
                "phases_s": phases}


def goodput_summary() -> Optional[Dict[str, Any]]:
    """The most recent GoodputTracker's summary (None before any run)."""
    return _goodput_latest.summary() if _goodput_latest is not None else None
