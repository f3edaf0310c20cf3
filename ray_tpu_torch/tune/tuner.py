"""Tuner + trial execution (the counterpart of ``ray_tpu/tune/tuner.py``).

Trials run as the port's tasks (``_tasks``), at most
``max_concurrent_trials`` at a time; ``tune.report`` inside a trial
publishes intermediate metrics through the driver's ``_control`` store
(``kv_put``; the trial connects to it as a client) and reads its stop
flag, so schedulers (ASHA, median stopping, HyperBand) can stop laggards
mid-flight and PBT can restart one from another's checkpoint.  The tuner
looks at the reports every ``POLL_S`` and hands those of one look to the
scheduler a step at a time, best first.  A trial
books what a default task books (one CPU) and sees every card: trials
that train on the card share it.

The trainable crosses by reference, as a task's function does (the port
has no cloudpickle): a function defined at the top level of a module.  A
lambda or a nested function raises ``ValueError`` at ``fit()``.
"""

from __future__ import annotations

import pickle
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from .schedulers import STOP, FIFOScheduler
from .search import generate_variants


#: Seconds between the tuner's looks at the trials' reports (JAX's 0.2 s):
#: a trial on the card reports every ~0.1 s, and a stop filed after its
#: last report comes too late to stop it.
POLL_S = 0.05


class TuneStopException(Exception):
    """Raised inside a trial when the scheduler stops it early."""


_trial_ctx: Optional[Dict[str, Any]] = None


#: In a trial worker: this process's client of each driver's store.
_planes: Dict[tuple, Any] = {}


def _plane_at(host: str, port: int):
    plane = _planes.get((host, port))
    if plane is None:
        from .._control import ControlPlane
        plane = _planes[(host, port)] = ControlPlane.connect(host, port)
    return plane


def report(metrics: Dict[str, Any],
           checkpoint: Optional[Dict[str, Any]] = None) -> None:
    """Report intermediate metrics from inside a trial; raises
    TuneStopException when the scheduler has stopped this trial.

    ``checkpoint`` (a picklable dict) is stored as the trial's latest
    checkpoint — PBT exploits clone it into restarted trials."""
    if _trial_ctx is None:
        raise RuntimeError("tune.report() called outside a tune trial")
    plane = _trial_ctx["plane"]

    def _control(verb: str, *args):
        return getattr(plane, verb)(*args)

    _trial_ctx["seq"] += 1
    metrics = dict(metrics)
    # NTP-immune trial elapsed, injected where schedulers/result rows can
    # actually read it (reference: tune auto-fills time_total_s).  A user
    # metric of the same name wins.
    metrics.setdefault("time_total_s",
                       time.monotonic() - _trial_ctx["t0_mono"])
    if checkpoint is not None:
        _control("kv_put",
                 f"tune/{_trial_ctx['run_id']}/ckpt/"
                 f"{_trial_ctx['trial_id']}", pickle.dumps(checkpoint))
    _control("kv_put",
             f"tune/{_trial_ctx['run_id']}/report/{_trial_ctx['trial_id']}/"
             f"{_trial_ctx['seq']}",
             pickle.dumps({"metrics": metrics,
                           "seq": _trial_ctx["seq"],
                           "time": time.time()}))  # wall: display only
    stop = _control(
        "kv_get", f"tune/{_trial_ctx['run_id']}/stop/"
                  f"{_trial_ctx['trial_id']}")
    if stop is not None:
        raise TuneStopException()


def get_checkpoint() -> Optional[Dict[str, Any]]:
    """Inside a trial: the checkpoint this trial was (re)started from
    (PBT exploit), or None for a fresh start."""
    if _trial_ctx is None:
        raise RuntimeError("tune.get_checkpoint() outside a tune trial")
    return _trial_ctx.get("initial_checkpoint")


def in_step_order(reports: List[tuple], mode: str) -> List[tuple]:
    """(step, value, ...) reports read in one look at the store, a step at
    a time and best first (JAX hands them to the scheduler in key order):
    two trials that report a rung together are ranked the same way
    whichever of them wrote first."""
    sign = 1.0 if mode == "min" else -1.0
    return sorted(reports, key=lambda r: (r[0], sign * r[1]))


def _run_trial(fn_blob: bytes, config: Dict[str, Any], run_id: str,
               trial_id: str, ckpt_blob: Optional[bytes], host: str,
               port: int):
    """One trial, run as a task."""
    global _trial_ctx
    from .._tasks import _resolve_fn
    fn = _resolve_fn(fn_blob)
    _trial_ctx = {"run_id": run_id, "trial_id": trial_id, "seq": 0,
                  "plane": _plane_at(host, port),
                  "t0_mono": time.monotonic(),
                  "initial_checkpoint":
                      pickle.loads(ckpt_blob) if ckpt_blob else None}
    try:
        out = fn(config)
        return {"final": out if isinstance(out, dict) else {},
                "stopped": False}
    except TuneStopException:
        return {"final": {}, "stopped": True}
    finally:
        _trial_ctx = None


@dataclass
class TuneConfig:
    metric: str = "loss"
    mode: str = "min"
    num_samples: int = 1
    max_concurrent_trials: int = 4
    scheduler: Any = None
    # Adaptive search algorithm (reference: tune_config.search_alg — e.g.
    # TPESearcher / ConcurrencyLimiter).  None = grid/random variants from
    # param_space.  With a search_alg, num_samples is the TOTAL number of
    # trials and param_space is owned by the searcher.
    search_alg: Any = None
    seed: int = 0


@dataclass
class TrialResult:
    trial_id: str
    config: Dict[str, Any]
    metrics: Dict[str, Any]
    error: Optional[str] = None
    stopped_early: bool = False
    history: List[Dict[str, Any]] = field(default_factory=list)
    restarts: int = 0  # PBT exploit relaunches


class ResultGrid:
    def __init__(self, results: List[TrialResult], metric: str, mode: str):
        self._results = results
        self._metric = metric
        self._mode = mode

    def __iter__(self):
        return iter(self._results)

    def __len__(self):
        return len(self._results)

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> TrialResult:
        metric = metric or self._metric
        mode = mode or self._mode
        scored = [r for r in self._results if metric in r.metrics]
        if not scored:
            raise ValueError(f"no trial reported metric {metric!r}")
        pick = min if mode == "min" else max
        return pick(scored, key=lambda r: r.metrics[metric])

    def get_dataframe(self):
        import pandas as pd
        rows = []
        for r in self._results:
            row = {"trial_id": r.trial_id, **{f"config/{k}": v
                                              for k, v in r.config.items()}}
            row.update(r.metrics)
            rows.append(row)
        return pd.DataFrame(rows)


class Tuner:
    """The trainable is a module-level function taking a config dict (the
    function-trainable API)."""

    def __init__(self, trainable: Callable,
                 *, param_space: Optional[Dict[str, Any]] = None,
                 tune_config: Optional[TuneConfig] = None):
        self._trainable = trainable
        self._param_space = param_space or {}
        self._cfg = tune_config or TuneConfig()

    def fit(self) -> ResultGrid:
        import ray_tpu_torch as rtt
        from .._actor import _plane
        from .._tasks import _fn_blob

        fn_blob = _fn_blob(self._trainable)   # ValueError: not by reference
        if not rtt.is_initialized():
            rtt.init()
        plane = _plane()

        def _control(verb: str, *args):
            return getattr(plane, verb)(*args)

        run_id = uuid.uuid4().hex[:12]
        scheduler = self._cfg.scheduler or FIFOScheduler()
        search_alg = self._cfg.search_alg
        run_remote = rtt.remote(_run_trial)

        trials: Dict[str, Dict[str, Any]] = {}
        queue = []

        def _new_trial(cfg: Dict[str, Any]) -> str:
            tid = uuid.uuid4().hex[:8]
            trials[tid] = {"config": cfg, "ref": None, "history": [],
                           "seen": set(), "ckpt_blob": None, "restarts": 0,
                           "kv_tid": tid}
            queue.append(tid)
            if hasattr(scheduler, "register_trial"):
                scheduler.register_trial(tid, cfg)
            return tid

        if search_alg is None:
            for cfg in generate_variants(self._param_space,
                                         self._cfg.num_samples,
                                         self._cfg.seed):
                _new_trial(cfg)
        suggested = 0

        in_flight: Dict[Any, str] = {}
        results: List[TrialResult] = []

        def poll_reports():
            new = []
            for key in _control("kv_keys", f"tune/{run_id}/report/"):
                parts = key.split("/")
                kv_tid, seq = parts[-2], int(parts[-1])
                # kv ids are generation-namespaced (tid.g<N> after a PBT
                # restart) so a relaunched trial's seqs can't collide with
                # its previous incarnation's.
                tid = kv_tid.split(".g")[0]
                t = trials.get(tid)
                if t is None or t["kv_tid"] != kv_tid \
                        or (kv_tid, seq) in t["seen"]:
                    continue
                t["seen"].add((kv_tid, seq))
                payload = pickle.loads(_control("kv_get", key))
                t["history"].append(payload["metrics"])
                metric_val = payload["metrics"].get(self._cfg.metric)
                if metric_val is not None:
                    new.append((seq, float(metric_val), tid, kv_tid))
            for seq, value, tid, kv_tid in in_step_order(new,
                                                         self._cfg.mode):
                if scheduler.on_result(tid, seq, value) == STOP:
                    _control("kv_put", f"tune/{run_id}/stop/{kv_tid}", b"1")

        def _searcher_refill():
            """Ask the search algorithm for more trials (suggest-driven
            mode; reference: SearchGenerator feeding TuneController)."""
            nonlocal suggested
            while suggested < self._cfg.num_samples and \
                    len(in_flight) + len(queue) < \
                    self._cfg.max_concurrent_trials:
                tid = uuid.uuid4().hex[:8]
                cfg = search_alg.suggest(tid)
                if cfg is None:
                    break  # limiter saturated or space exhausted
                trials[tid] = {"config": cfg, "ref": None, "history": [],
                               "seen": set(), "ckpt_blob": None,
                               "restarts": 0, "kv_tid": tid}
                # NOTE: tid is pre-chosen so the searcher sees the same id
                # the tuner reports completion with.
                queue.append(tid)
                if hasattr(scheduler, "register_trial"):
                    scheduler.register_trial(tid, cfg)
                suggested += 1

        if search_alg is not None:
            _searcher_refill()
        while queue or in_flight or (
                search_alg is not None
                and suggested < self._cfg.num_samples):
            if search_alg is not None:
                _searcher_refill()
                if not queue and not in_flight:
                    # Limiter blocked with nothing running: cannot progress.
                    break
            while queue and len(in_flight) < self._cfg.max_concurrent_trials:
                tid = queue.pop(0)
                ref = run_remote.options(
                    name=f"trial-{tid}").remote(
                        fn_blob, trials[tid]["config"], run_id,
                        trials[tid]["kv_tid"], trials[tid]["ckpt_blob"],
                        plane.host, plane.port)
                trials[tid]["ref"] = ref
                in_flight[ref] = tid
            done, _ = rtt.wait(list(in_flight.keys()), num_returns=1,
                                   timeout=POLL_S)
            poll_reports()
            for ref in done:
                tid = in_flight.pop(ref)
                t = trials[tid]
                error = None
                stopped = False
                final: Dict[str, Any] = {}
                try:
                    out = rtt.get(ref)
                    final = out["final"]
                    stopped = out["stopped"]
                except Exception as e:  # noqa: BLE001
                    error = repr(e)
                # PBT exploit: the stop was a pause — relaunch the trial
                # with the mutated config seeded from a top performer's
                # checkpoint (reference: pbt.py exploit/explore cycle).
                restart = None
                if hasattr(scheduler, "take_restart"):
                    # Always drain the directive: a STOP landing on the
                    # trial's final report leaves one behind, which must
                    # not leak (the trial completed anyway).
                    restart = scheduler.take_restart(tid)
                _control("kv_del", f"tune/{run_id}/stop/{t['kv_tid']}")
                if stopped and restart is not None and t["restarts"] < 16:
                    new_config, source = restart
                    t["config"] = new_config
                    t["restarts"] += 1
                    t["kv_tid"] = f"{tid}.g{t['restarts']}"
                    src_kv = trials[source]["kv_tid"] \
                        if source in trials else source
                    t["ckpt_blob"] = _control(
                        "kv_get", f"tune/{run_id}/ckpt/{src_kv}") or \
                        _control("kv_get", f"tune/{run_id}/ckpt/{source}")
                    if hasattr(scheduler, "register_trial"):
                        scheduler.register_trial(tid, new_config)
                    queue.append(tid)
                    continue
                last = t["history"][-1] if t["history"] else {}
                metrics = {**last, **final}
                if search_alg is not None:
                    # Searchers minimize; flip for mode="max".
                    val = metrics.get(self._cfg.metric)
                    score = None
                    if val is not None:
                        score = float(val) if self._cfg.mode == "min" \
                            else -float(val)
                    search_alg.on_trial_complete(tid, score)
                results.append(TrialResult(
                    tid, t["config"], metrics, error, stopped,
                    t["history"], restarts=t["restarts"]))
        poll_reports()
        return ResultGrid(results, self._cfg.metric, self._cfg.mode)
