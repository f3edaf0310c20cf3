"""Step attribution: decompose a training step into phases (counterpart of
ray_tpu/profiler/attribution.py).

``train.step_phase`` marks what each slice of a step's wall time was
(waiting on the input pipeline, host-to-device copies, compute,
collectives), fencing at phase boundaries so the card's asynchronous
launches cannot smear one phase's device work into the next::

    with train.step_phase("data_wait"):
        batch = next(it)
    with train.step_phase("compute"):
        params, opt, m = train.fence(step_fn(params, opt, batch))
    train.report({"loss": float(m["loss"])})

``report()`` pops the accumulated phases, adds ``ckpt_block`` and a derived
``other`` for the unattributed remainder, observes
``ray_tpu_train_step_phase_seconds{phase}`` (rank 0) and ships the dict to
the controller (``Result.step_phases``, goodput's data-wait share).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

DERIVED_PHASES = ("ckpt_block", "other")

_tls = threading.local()


def _phases() -> Dict[str, float]:
    acc = getattr(_tls, "phases", None)
    if acc is None:
        acc = _tls.phases = {}
    return acc


def _cuda_devices(value: Any, out: set) -> set:
    import torch
    if isinstance(value, torch.Tensor):
        if value.device.type == "cuda":
            out.add(value.device)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, out)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _cuda_devices(v, out)
    return out


def fence(value: Any) -> Any:
    """Wait until the work that produces ``value`` is done, then return it
    unchanged: synchronizes every CUDA device that holds a tensor of
    ``value`` (nothing for CPU tensors and non-tensors).  JAX's calls
    ``jax.block_until_ready``."""
    devices = _cuda_devices(value, set())
    if devices:
        import torch
        for dev in devices:
            torch.cuda.synchronize(dev)
    return value


class step_phase:
    """Context manager charging its wall time to one named phase of the
    current step.  Nestable: nested time is charged to the inner phase
    only, so the phases sum to at most the step time.  ``fence_result=x``
    fences on ``x`` before the phase closes."""

    __slots__ = ("name", "_fence_result", "_stack")

    def __init__(self, name: str, fence_result: Any = None):
        self.name = name
        self._fence_result = fence_result
        self._stack: list = []

    def fence(self, value: Any) -> Any:
        return fence(value)

    def __enter__(self) -> "step_phase":
        self._stack.append({"t0": time.monotonic(), "child_s": 0.0,
                            "parent": getattr(_tls, "open_phase", None)})
        _tls.open_phase = self._stack[-1]
        return self

    def __exit__(self, *exc) -> bool:
        if self._fence_result is not None:
            fence(self._fence_result)
        entry = self._stack.pop()
        dur = max(0.0, time.monotonic() - entry["t0"])
        _tls.open_phase = entry["parent"]
        if entry["parent"] is not None:
            entry["parent"]["child_s"] += dur
        acc = _phases()
        acc[self.name] = acc.get(self.name, 0.0) + max(
            0.0, dur - entry["child_s"])
        return False


def pop_phases() -> Dict[str, float]:
    """Return and clear this thread's accumulated phase seconds."""
    acc = _phases()
    out = dict(acc)
    acc.clear()
    return out


def finalize_step_phases(phases: Dict[str, float], step_s: Optional[float],
                         ckpt_s: float = 0.0) -> Dict[str, float]:
    """Fold checkpoint-blocking time in and derive ``other``, the slice of
    the step no phase claimed (``step_s`` None: the first report, nothing
    to difference against, no ``other``)."""
    out = {k: v for k, v in phases.items() if v > 0.0}
    if ckpt_s > 0.0:
        out["ckpt_block"] = out.get("ckpt_block", 0.0) + ckpt_s
    if step_s is not None and step_s > 0.0:
        out["other"] = max(0.0, step_s - sum(out.values()))
    return out


_last_hbm_mono = 0.0
_hbm_lock = threading.Lock()


def note_hbm_gauges(min_interval_s: float = 1.0) -> None:
    """Refresh the card's memory gauges (``torch.cuda.memory_allocated``
    and ``max_memory_allocated`` of this process's card), at most once a
    ``min_interval_s``.  Absent where this process has not initialised
    CUDA (CPU workers), as JAX's are absent on backends without memory
    stats."""
    global _last_hbm_mono
    import torch
    if not torch.cuda.is_initialized():
        return
    now = time.monotonic()
    with _hbm_lock:
        if now - _last_hbm_mono < min_interval_s:
            return
        _last_hbm_mono = now
    from ..util import telemetry
    idx = torch.cuda.current_device()
    tags = {"device": f"cuda:{idx}"}
    telemetry.set_gauge("ray_tpu_train_hbm_used_bytes",
                        float(torch.cuda.memory_allocated(idx)), tags=tags)
    telemetry.set_gauge("ray_tpu_train_hbm_peak_bytes",
                        float(torch.cuda.max_memory_allocated(idx)),
                        tags=tags)


def _reset_for_tests() -> None:
    global _last_hbm_mono
    _phases().clear()
    _tls.open_phase = None
    _last_hbm_mono = 0.0
