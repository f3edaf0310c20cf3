"""ray_tpu_torch.llm.disagg: disaggregated LLM serving (counterpart of
ray_tpu/llm/disagg).

Prefill/decode split with the KV handed from a prefill worker (its own CUDA
stream) to a decode engine on the same card, SLO-aware admission control
(per-class token budgets, bounded queues with deadline shedding, KV
occupancy backpressure), and the open-loop load generator.  The same
exports as the JAX package; the object-store transport and the serve
deployment raise until ROADMAP Queue 1 item 6.
"""

from .handoff import KVHandoff, export_handoff, import_handoff
from .loadgen import ServeLoadSpec, run_open_loop
from .prefill import PrefillWorker
from .router import (AdmissionConfig, AdmissionController, DisaggServer,
                     OverloadError, RequestClass, build_disagg_deployment)

__all__ = [
    "KVHandoff", "export_handoff", "import_handoff",
    "PrefillWorker",
    "AdmissionConfig", "AdmissionController", "RequestClass",
    "DisaggServer", "OverloadError", "build_disagg_deployment",
    "ServeLoadSpec", "run_open_loop",
]
