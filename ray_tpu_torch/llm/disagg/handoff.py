"""KV handoff: the sealed object a prefill worker hands a decode worker
(counterpart of ray_tpu/llm/disagg/handoff.py).

The prefill tier computes the prompt's KV once; the decode tier imports it
into its own paged cache (``InferenceEngine.import_prefill``) and joins the
request to its continuous batch.  In one process the handoff stays on the
card: its ``ks``/``vs`` are the prefill's tensors, and the import is one
device-to-device scatter (``_model.write_prefill``) on the decode engine's
stream, ordered after the prefill by the handoff's ``ready`` event.

Across processes on one host a handoff is sealed into the port's object
store (``export_handoff``) and opened by descriptor (``import_handoff``):
host K/V travel through shared memory, K/V on the card through CUDA IPC
handles, so the decode process reads the prefill's memory in place, and
the ``ready`` event goes along as an interprocess event.  The exporter
releases the blob (``ray_tpu_torch._object_store.release_page_blob``) only
after the importer's scatter has finished on the device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ...util import telemetry
from ..engine import SamplingParams


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(np.asarray(x).nbytes)


@dataclass
class KVHandoff:
    """A prefilled prompt ready to join a decode worker's batch.

    ``ks``/``vs`` are the per-layer K/V of the prompt, trimmed to its pages
    rounded up to a power of two, in the prefill's ``[L, S_keep, Hkv, D]``
    layout: the input of the decode engine's ``write_prefill`` scatter, so
    import needs no relayout.  They are torch tensors (on the card in one
    process) or numpy arrays (a handoff carried over from the JAX
    package).  ``ready`` is a CUDA event recorded after the prefill that
    made them, or None where there is nothing to wait for.
    """

    prompt_tokens: List[int]
    first_token: int
    ks: Any
    vs: Any
    params: SamplingParams
    t_submit: float = 0.0     # perf_counter at request submission
    t_first: float = 0.0      # perf_counter when prefill sampled token 0
    ready: Optional[Any] = None

    @property
    def nbytes(self) -> int:
        return _nbytes(self.ks) + _nbytes(self.vs)

    def numpy(self) -> "KVHandoff":
        """This handoff with host numpy K/V (bf16 widened to fp32, which
        numpy has): the form the JAX package's engine imports."""
        if self.ready is not None:
            torch.cuda.current_stream().wait_event(self.ready)

        def host(x):
            if isinstance(x, torch.Tensor):
                if x.dtype == torch.bfloat16:
                    x = x.float()
                return x.detach().cpu().numpy()
            return np.asarray(x)
        return replace(self, ks=host(self.ks), vs=host(self.vs), ready=None)


def export_handoff(store, object_id, handoff: KVHandoff
                   ) -> Optional[tuple]:
    """Seal ``handoff`` into ``store`` (a
    ``ray_tpu_torch._object_store.SharedMemoryStore``) and return the
    descriptor a process on this host imports it by; None when the store
    cannot hold it (the caller then hands the object off directly).

    K/V on the card stay where they are: the descriptor carries their IPC
    handles, and ``ready`` is replaced by an interprocess event recorded
    after it, which the importer's stream waits on."""
    from ..._object_store import export_page_blob
    t0 = time.perf_counter()
    if isinstance(handoff.ks, torch.Tensor) and handoff.ks.is_cuda:
        device = handoff.ks.device
        stream = torch.cuda.current_stream(device)
        if handoff.ready is not None:
            stream.wait_event(handoff.ready)
        ready = torch.cuda.Event(interprocess=True)
        ready.record(stream)
        handoff = replace(handoff, ready=ready)
    desc = export_page_blob(store, object_id, handoff)
    if desc is not None:
        telemetry.observe("ray_tpu_llm_kv_transfer_seconds",
                          time.perf_counter() - t0, tags={"op": "export"})
        telemetry.inc("ray_tpu_llm_kv_transfer_bytes_total", handoff.nbytes)
    return desc


def import_handoff(desc: tuple) -> Tuple[KVHandoff, Any]:
    """Open an exported handoff by descriptor.  Returns (handoff,
    keepalive): host K/V are views of the shared mapping while the
    keepalive is held; K/V on the card are the exporter's memory, opened
    through its IPC handles (in the exporting process, its own tensors).
    The importer needs them until its ``write_prefill`` scatter has run."""
    from ..._object_store import import_page_blob
    t0 = time.perf_counter()
    handoff, keepalive = import_page_blob(desc)
    telemetry.observe("ray_tpu_llm_kv_transfer_seconds",
                      time.perf_counter() - t0, tags={"op": "import"})
    return handoff, keepalive
