"""Host <-> device transfers of the RL layer, kept in one place because they
are where the host waits for the card.

Host -> device copies go through pinned memory with ``non_blocking=True``,
so they do not stop the host (torch's sync debug mode counts none).  Every
device -> host read is one ``.cpu()`` of one tensor: ``fetch`` stacks the
per-env vectors of a step (actions, log-probs, values) and
``fetch_metrics`` a metrics dict into one tensor first, which is the port's
form of the JAX package's batched ``jax.device_get`` (README "RT502": a
per-value read costs one sync each).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .._tree import tree_map


def _leaf_to(x: Any, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        # Non-blocking only toward the card: a non-blocking copy to the
        # host returns before its bytes have landed.
        return x.to(device, non_blocking=device.type == "cuda")
    a = np.asarray(x)
    # JAX runs without x64: float64 host data enters its programs as fp32.
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    elif not a.flags.writeable or not a.flags.c_contiguous:
        a = np.array(a, order="C")        # keeps 0-d arrays 0-d
    t = torch.from_numpy(a)
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t


def to_device(tree: Any, device: torch.device) -> Any:
    """numpy arrays (or tensors) of a tree -> tensors on ``device``."""
    return tree_map(lambda x: _leaf_to(x, device), tree)


def to_numpy(tree: Any) -> Any:
    """Tensors (or JAX arrays) of a tree -> numpy arrays on the host."""
    return tree_map(lambda x: x.detach().cpu().numpy()
                    if isinstance(x, torch.Tensor) else np.asarray(x), tree)


def fetch(*vectors: torch.Tensor) -> np.ndarray:
    """Same-length vectors -> one fp32 ``[len(vectors), n]`` host array in
    ONE device -> host transfer (integer actions are exact in fp32)."""
    return torch.stack([v.reshape(-1).to(torch.float32)
                        for v in vectors]).cpu().numpy()


def fetch_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """A dict of scalar tensors -> floats, keys sorted as JAX's
    ``device_get`` of a dict returns them, in ONE transfer."""
    keys = sorted(metrics)
    vals = fetch(*(torch.as_tensor(metrics[k]) for k in keys))[:, 0]
    return {k: float(v) for k, v in zip(keys, vals)}
