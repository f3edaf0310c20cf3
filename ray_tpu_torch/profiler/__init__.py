"""Profiling helpers of the port (counterpart of ray_tpu/profiler): so far
step-phase attribution."""

from .attribution import fence, step_phase

__all__ = ["fence", "step_phase"]
