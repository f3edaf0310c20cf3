"""KV handoff: the sealed object a prefill worker hands a decode worker
(counterpart of ray_tpu/llm/disagg/handoff.py).

The prefill tier computes the prompt's KV once; the decode tier imports it
into its own paged cache (``InferenceEngine.import_prefill``) and joins the
request to its continuous batch.  In one process the handoff stays on the
card: its ``ks``/``vs`` are the prefill's tensors, and the import is one
device-to-device scatter (``_model.write_prefill``) on the decode engine's
stream, ordered after the prefill by the handoff's ``ready`` event.

The JAX package also seals a handoff into its shared-memory object store
(``export_handoff``/``import_handoff``) so a decode worker in another
process maps it; that transport crosses process boundaries and comes with
the serve runtime (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, List, Optional

import numpy as np
import torch

from ..engine import SamplingParams

#: Names the ROADMAP entry that brings what this module refuses.
_ITEM_6 = "ROADMAP Queue 1 item 6 (the serve deployment over processes)"


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


def export_handoff(store, object_id, handoff: KVHandoff):
    """Sealing a handoff into a shared-memory object store, for a decode
    worker in another process, is not ported yet."""
    raise NotImplementedError(
        f"export_handoff (the object-store transport of a KV handoff "
        f"across processes) comes with {_ITEM_6}; in one process pass the "
        f"KVHandoff to import_prefill directly")


def import_handoff(desc):
    """Mapping an exported handoff by descriptor is not ported yet."""
    raise NotImplementedError(
        f"import_handoff (the object-store transport of a KV handoff "
        f"across processes) comes with {_ITEM_6}; in one process pass the "
        f"KVHandoff to import_prefill directly")
