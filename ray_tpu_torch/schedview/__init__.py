"""Scheduler decision tracing (a copy of the part of ``ray_tpu/schedview``
the scheduler records into): :class:`DecisionRing`, a bounded ring of
placement decisions, the closed vocabulary of rejection reasons (``R_*``),
and the ``enabled``/``set_enabled`` switch (``RAY_TPU_SCHED_TRACE=0``
turns tracing off).
"""

from .decisions import (DecisionRing, R_AFFINITY, R_BUNDLE, R_DRAINING,
                        R_INFEASIBLE, R_INSUFFICIENT, R_NO_NODES,
                        R_PENDING_DEPS, REASON_CODES, enabled, set_enabled)

__all__ = [
    "DecisionRing",
    "REASON_CODES",
    "R_AFFINITY",
    "R_BUNDLE",
    "R_DRAINING",
    "R_INFEASIBLE",
    "R_INSUFFICIENT",
    "R_NO_NODES",
    "R_PENDING_DEPS",
    "enabled",
    "set_enabled",
]
