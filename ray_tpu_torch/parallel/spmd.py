"""The training step (counterpart of ray_tpu/parallel/spmd.py), on the one
device of a ``build_mesh`` mesh.

``make_lm_train_step`` returns ``(init_fn, step_fn, place_batch)`` with the
JAX signatures' meaning.  The step is eager PyTorch: ``loss_fn`` forward,
``torch.autograd.grad`` over the parameter leaves (not ``torch.func``: the
flash kernels' ``autograd.Function`` has no vmap rule, and no ``.grad``
attributes are kept), then the optimizer's in-place update, which is the
port's form of ``donate_argnums``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .._tree import tree_leaves, tree_map
from ..models import llama as L
from ..optim import AdamState, adamw, global_norm
from .mesh import Mesh


def _clone(tree: Any) -> Any:
    """A copy of a params tree or an ``AdamState``, leaves detached."""
    if isinstance(tree, AdamState):
        return AdamState(tree.count.clone(), _clone(tree.mu), _clone(tree.nu))
    return tree_map(
        lambda t: t.detach().clone().requires_grad_(t.requires_grad), tree)


def _grads(params: Any, batch: Dict[str, torch.Tensor], cfg):
    leaves = tree_leaves(params)
    for t in leaves:
        if not t.requires_grad:
            t.requires_grad_(True)
    loss = L.loss_fn(params, batch, cfg)
    grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    return loss.detach(), list(grads)


def make_lm_train_step(cfg, mesh: Mesh, *, optimizer=None,
                       learning_rate: float = 3e-4, donate: bool = True,
                       param_dtype: Optional[torch.dtype] = None,
                       grad_accum: int = 1):
    """Build (init_fn, step_fn, place_batch) for a models.llama LM on
    ``mesh``'s device.

    init_fn(generator) -> (params, opt_state); ``generator`` lives on the
    mesh's device.  step_fn(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"}), the metrics as device scalars (no host sync).

    ``param_dtype`` overrides parameter (and hence optimizer-state)
    storage.  ``donate`` (the default) updates params and opt_state in
    place; with ``donate=False`` the step works on copies and the caller's
    trees stay as they were.  ``grad_accum`` > 1 splits the batch's leading
    dim into that many microbatches, each normalised by the full batch's
    token count, and sums their gradients in the params' dtype before one
    update."""
    optimizer = optimizer or adamw(learning_rate, b1=0.9, b2=0.95,
                                   weight_decay=0.1)
    device = mesh.device
    L.check_supported(cfg)

    def init_fn(generator: torch.Generator):
        params = L.init_params(cfg, generator,
                               param_dtype=param_dtype or torch.float32,
                               device=device)
        for t in tree_leaves(params):
            t.requires_grad_(True)
        return params, optimizer.init(params)

    def step_fn(params, opt_state: AdamState, batch):
        if not donate:
            params, opt_state = _clone(params), _clone(opt_state)
        if grad_accum > 1:
            loss, grads = _accumulate(params, batch)
        else:
            loss, grads = _grads(params, batch, cfg)
        gnorm = global_norm(grads)
        opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    def _accumulate(params, batch):
        b = batch["tokens"].shape[0]
        if b % grad_accum:
            raise ValueError(f"batch {b} not divisible by grad_accum="
                             f"{grad_accum}")
        # Every microbatch normalises by the FULL batch's unmasked token
        # count, so the summed losses and gradients equal the unaccumulated
        # step even when masking is uneven across microbatches.
        if "loss_mask" in batch:
            denom = batch["loss_mask"].float().sum().clamp_min(1.0)
        else:
            t = batch["tokens"]
            denom = torch.tensor(float(t.shape[0] * (t.shape[1] - 1)),
                                 device=t.device)
        micro = {k: v.chunk(grad_accum) for k, v in batch.items()}
        gsum, lsum = None, torch.zeros((), device=device)
        for i in range(grad_accum):
            mb = {k: v[i] for k, v in micro.items()}
            mb["loss_denom"] = denom
            loss, grads = _grads(params, mb, cfg)
            if gsum is None:
                # The accumulator is in the params' dtype, as in JAX.
                gsum = [torch.zeros_like(p, requires_grad=False)
                        for p in tree_leaves(params)]
            torch._foreach_add_(gsum, grads)
            lsum = lsum + loss
        return lsum, gsum

    def place_batch(batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: (v if isinstance(v, torch.Tensor)
                    else torch.as_tensor(np.asarray(v))).to(device)
                for k, v in batch.items()}

    return init_fn, step_fn, place_batch


def make_lm_eval_step(cfg, mesh: Mesh):
    """eval_step(params, batch) -> loss, without a graph."""
    L.check_supported(cfg)

    @torch.no_grad()
    def eval_step(params, batch):
        return L.loss_fn(params, batch, cfg)

    return eval_step
