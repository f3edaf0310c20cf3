"""The training step (counterpart of ray_tpu/parallel/spmd.py).

``make_lm_train_step`` returns ``(init_fn, step_fn, place_batch)`` with the
JAX signatures' meaning.  The step is eager PyTorch: ``loss_fn`` forward,
``torch.autograd.grad`` over the parameter leaves (not ``torch.func``: the
flash kernels' ``autograd.Function`` has no vmap rule, and no ``.grad``
attributes are kept), then the optimizer: the port's ``optim.AdamW``
updates in place, which is the port's form of ``donate_argnums``; any other
optimizer is an optax-shaped ``GradientTransformation`` (``optim.adam``,
``optim.chain(...)``), whose ``update`` returns the updates and the new
state, applied with ``optim.apply_updates`` as JAX's step does.

On the one-device mesh everything is a plain tensor on the mesh's device.

On a mesh of several ranks, params and the adam moments are DTensors laid
out by the logical-axis rules (``param_logical_axes`` through
``parallel.sharding``), mu and nu each with exactly its param's placements
and ``count`` a plain scalar every rank holds.  A step, where JAX leaves the
collectives to GSPMD, does them explicitly:

- each param is gathered over every mesh axis but tp, ep and pp (FSDP's
  all-gather); with the default rules' tp layout (heads, kv_heads and mlp
  over tp) the blocks run Megatron-style on the rank's heads and mlp
  columns, and the flash kernels see plain local tensors of the rank's
  batch rows and heads, with no communication; the vocab-sharded embed and
  lm_head are gathered whole;
- ep (MoE models): each rank keeps its share of every layer's experts and
  computes them on the tokens of its (dp, fsdp, sp) block, which every ep
  rank of a group holds; the experts' outputs are summed over ep.  The
  routing sees the whole batch's expert indices (an int32 all-gather over
  the token-holding ranks), so capacity and drops are JAX's;
- sp: each rank holds positions ``[i * S / sp, (i + 1) * S / sp)`` of its
  rows (targets and the default mask built on the whole row first, RoPE at
  the block's global positions), and attention runs over the sp group
  (ring, Ulysses, or K/V gathered for the other impls);
- pp with ``pp_microbatches``: each rank keeps its stage's layers and the
  blocks run on ``parallel.pipeline``'s GPipe schedule;
- the model gets its process groups through
  ``models.llama.parallel_groups``;
- the batch is sharded over (dp, fsdp) rows and sp positions; every rank's
  loss is normalised by the whole batch's token count, so the gradients of
  the gathered copies are partial sums over (dp, fsdp, sp), reduced onto
  each param's own placements (FSDP's reduce-scatter; an all-reduce over
  dp and sp);
- adamw takes the DTensor trees and updates each leaf's local block
  (param, gradient, mu and nu share one layout);
- ``loss`` and ``grad_norm`` come back as plain scalars with the same
  value on every rank (reduced on the device, no host sync).

An init is the same on every mesh shape: the full params are drawn from the
generator as on one device, then each rank keeps its own blocks.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .._tree import tree_leaves, tree_map, tree_unflatten
from ..models import llama as L
from ..optim import (AdamState, AdamW, adamw, apply_updates, blockwise_norm,
                     global_norm)
from .mesh import (AXIS_DATA, AXIS_EXPERT, AXIS_FSDP, AXIS_PIPELINE,
                   AXIS_SEQ, AXIS_TENSOR, CANONICAL_ORDER, Mesh,
                   set_global_mesh)
from .sharding import (NamedSharding, ShardingRules, default_rules,
                       distribute, is_primary, logical_to_placements)

#: The axes whose ranks hold different tokens: the loss, its denominator
#: and the gradients are sums over them.
_BATCH_AXES = (AXIS_DATA, AXIS_FSDP, AXIS_SEQ)


def _clone(tree: Any) -> Any:
    """A copy of a params tree or an ``AdamState``, leaves detached."""
    if isinstance(tree, AdamState):
        return AdamState(tree.count.clone(), _clone(tree.mu), _clone(tree.nu))
    return tree_map(
        lambda t: t.detach().clone().requires_grad_(t.requires_grad), tree)


def _update(optimizer, params: Any, grads: list, opt_state: Any,
            plan: Optional["_ShardedPlan"] = None):
    """One optimizer update -> (params, opt_state).  The port's ``AdamW``
    updates ``params`` in place; a ``GradientTransformation`` gets the
    gradients in the params' tree and its updates are added to new params
    (keeping each leaf's ``requires_grad``).

    On a mesh of several ranks (``plan``) the transformation runs on each
    rank's local blocks, as adamw does (a param, its gradient and its state
    leaves share one layout, so an elementwise step on the blocks is the
    step of the whole arrays; DTensor's own dispatch takes minutes a step),
    with ``optim.global_norm`` summed over the ranks; the results are
    wrapped back with their DTensors' placements."""
    if isinstance(optimizer, AdamW):
        return params, optimizer.update(grads, opt_state, params)
    if plan is None:
        with torch.no_grad():
            updates, opt_state = optimizer.update(
                tree_unflatten(params, grads), opt_state, params)
            new = apply_updates(params, updates)
        return tree_map(lambda n, p: n.requires_grad_(p.requires_grad), new,
                        params), opt_state
    from torch.distributed.tensor import DTensor
    local = lambda t: t.to_local() if isinstance(t, DTensor) else t
    wrap = lambda new, old: DTensor.from_local(
        new, old.device_mesh, old.placements, run_check=False,
        shape=old.shape, stride=old.stride()) if isinstance(
            old, DTensor) else new
    blocks = tree_map(local, params)
    with torch.no_grad(), blockwise_norm(plan.blockwise_norm(params)):
        updates, state = optimizer.update(
            tree_unflatten(blocks, [local(g) for g in grads]),
            tree_map(local, opt_state), blocks)
        new = apply_updates(blocks, updates)
    return (tree_map(lambda n, p: wrap(n, p).requires_grad_(p.requires_grad),
                     new, params),
            tree_map(wrap, state, opt_state))


def _grads(params: Any, batch: Dict[str, torch.Tensor], cfg,
           positions: Optional[torch.Tensor] = None):
    leaves = tree_leaves(params)
    for t in leaves:
        if not t.requires_grad:
            t.requires_grad_(True)
    loss = L.loss_fn(params, batch, cfg, positions)
    grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    return loss.detach(), list(grads)


def _loss_denom(batch) -> torch.Tensor:
    """The whole batch's unmasked token count (fp32 scalar)."""
    if "loss_mask" in batch:
        return batch["loss_mask"].float().sum().clamp_min(1.0)
    t = batch["tokens"]
    return torch.tensor(float(t.shape[0] * (t.shape[1] - 1)),
                        device=t.device)


def _accumulated_grads(params, batch, cfg, grad_accum: int, denom,
                       positions: Optional[torch.Tensor] = None):
    """Loss and gradients over ``grad_accum`` microbatches of ``batch``'s
    leading dim, each normalised by ``denom`` (the full batch's token
    count), summed in the params' dtype."""
    b = batch["tokens"].shape[0]
    if b % grad_accum:
        raise ValueError(f"batch {b} not divisible by grad_accum="
                         f"{grad_accum}")
    micro = {k: v.chunk(grad_accum) for k, v in batch.items()}
    gsum, lsum = None, torch.zeros((), device=denom.device)
    for i in range(grad_accum):
        mb = {k: v[i] for k, v in micro.items()}
        mb["loss_denom"] = denom
        loss, grads = _grads(params, mb, cfg, positions)
        if gsum is None:
            # The accumulator is in the params' dtype, as in JAX.
            gsum = [torch.zeros_like(p, requires_grad=False)
                    for p in tree_leaves(params)]
        torch._foreach_add_(gsum, grads)
        lsum = lsum + loss
    return lsum, gsum


def batch_pspec(mesh: Mesh, rules: Optional[ShardingRules] = None) -> list:
    """Token batches: [B, S] -> placements with B over (dp, fsdp) and S
    over sp."""
    return logical_to_placements(("batch", "seq"), ShardingRules(
        {"batch": (AXIS_DATA, AXIS_FSDP), "seq": AXIS_SEQ}), mesh)


def make_lm_train_step(cfg, mesh: Mesh, *,
                       rules: Optional[ShardingRules] = None,
                       optimizer=None, learning_rate: float = 3e-4,
                       donate: bool = True,
                       param_dtype: Optional[torch.dtype] = None,
                       grad_accum: int = 1):
    """Build (init_fn, step_fn, place_batch) for a models.llama LM on
    ``mesh``.

    init_fn(generator) -> (params, opt_state), laid out on the mesh;
    ``generator`` lives on the mesh's device.  step_fn(params, opt_state,
    batch) -> (params, opt_state, {"loss", "grad_norm"}), the metrics as
    device scalars (no host sync).  place_batch(batch) puts a whole batch
    (every rank passes the same one) on the mesh.

    ``param_dtype`` overrides parameter (and hence optimizer-state)
    storage.  ``donate`` (the default) updates params and opt_state in
    place; with ``donate=False`` the step works on copies and the caller's
    trees stay as they were.  ``grad_accum`` > 1 splits the batch's leading
    dim into that many microbatches, each normalised by the full batch's
    token count, and sums their gradients in the params' dtype before one
    update.  ``rules``: the logical-axis table (default_rules).
    ``optimizer``: the port's ``optim.adamw`` (the default, in place) or
    any optax-shaped ``GradientTransformation``."""
    optimizer = optimizer or adamw(learning_rate, b1=0.9, b2=0.95,
                                   weight_decay=0.1)
    L.check_supported(cfg)
    L.check_device_supported(cfg, mesh.device)
    set_global_mesh(mesh)
    if mesh.device_mesh is None:
        return _one_device_step(cfg, mesh, optimizer, donate, param_dtype,
                                grad_accum)
    plan = _ShardedPlan(cfg, mesh, rules or default_rules())

    def init_fn(generator: torch.Generator):
        full = L.init_params(cfg, generator,
                             param_dtype=param_dtype or torch.float32,
                             device=generator.device)
        params = plan.place_params(full)
        return params, optimizer.init(params)

    def step_fn(params, opt_state: AdamState, batch):
        if not donate:
            params, opt_state = _clone(params), _clone(opt_state)
        loss, grads = plan.loss_and_grads(params, batch, grad_accum)
        gnorm = plan.global_norm(grads)
        params, opt_state = _update(optimizer, params, grads, opt_state,
                                    plan)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return init_fn, step_fn, plan.place_batch


def _one_device_step(cfg, mesh: Mesh, optimizer, donate, param_dtype,
                     grad_accum):
    device = mesh.device

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
            loss, grads = _accumulated_grads(params, batch, cfg, grad_accum,
                                             _loss_denom(batch))
        else:
            loss, grads = _grads(params, batch, cfg)
        gnorm = global_norm(grads)
        params, opt_state = _update(optimizer, params, grads, opt_state)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    def place_batch(batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: _as_tensor(v).to(device) for k, v in batch.items()}

    return init_fn, step_fn, place_batch


def _as_tensor(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(
        np.asarray(v))


class _ShardedPlan:
    """The layouts of one sharded step: each param's placements at rest
    and for compute, the batch's, the collectives between them, and the
    process groups the model runs over."""

    def __init__(self, cfg, mesh: Mesh, rules: ShardingRules):
        self.cfg, self.mesh = cfg, mesh
        self.dm = mesh.device_mesh
        shape = mesh.shape
        pipeline = bool(cfg.pp_microbatches) and shape[AXIS_PIPELINE] > 1
        if pipeline:
            # Each stage holds its layers (JAX: rules.replace(layers="pp")).
            rules = rules.replace(layers=AXIS_PIPELINE)
        ep = shape[AXIS_EXPERT] if cfg.num_experts else 1
        if cfg.num_experts % ep:
            raise ValueError(f"num_experts={cfg.num_experts} does not "
                             f"divide over ep={ep}")
        logical = dict(_named_leaves(L.param_logical_axes(cfg)))
        #: leaf name -> its NamedSharding at rest.
        self.shardings = {
            name: NamedSharding(mesh, tuple(logical_to_placements(
                ax, rules, mesh)))
            for name, ax in logical.items()}
        tp = shape[AXIS_TENSOR]
        # Megatron blocks where the rules put heads, kv_heads and mlp on
        # tp, and tp divides them; else tp ranks gather everything and
        # repeat the same work.
        self.megatron = tp > 1 and all(
            rules.axes_for(n) in (AXIS_TENSOR, (AXIS_TENSOR,))
            for n in ("heads", "kv_heads", "mlp")) and not (
            cfg.heads % tp or cfg.kv_heads % tp or cfg.mlp_dim % tp)
        keep_tp = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"}

        def kept(name, axis):
            """Whether compute keeps the leaf's split over ``axis``."""
            if axis == AXIS_TENSOR:
                return self.megatron and name in keep_tp
            if axis == AXIS_EXPERT:
                return ep > 1 and "expert" in logical[name]
            return axis == AXIS_PIPELINE and pipeline

        self.compute = {
            name: tuple(p if kept(name, a) else _replicate()
                        for a, p in zip(CANONICAL_ORDER, sh.placements))
            for name, sh in self.shardings.items()}
        self.batch = NamedSharding(mesh, tuple(batch_pspec(mesh)))
        self.sp = shape[AXIS_SEQ]
        self.groups = L.ParallelGroups(
            tp=mesh.group(AXIS_TENSOR) if self.megatron else None,
            ep=mesh.group(AXIS_EXPERT) if ep > 1 else None,
            sp=mesh.group(AXIS_SEQ) if self.sp > 1 else None,
            pp=mesh.group(AXIS_PIPELINE) if pipeline else None,
            moe=self._moe(ep) if cfg.num_experts else None)

    def _moe(self, ep: int):
        """Routing over the whole batch: the expert indices gathered from
        the (dp, fsdp, sp) ranks, and this rank's experts."""
        from ..ops.moe import MoEParallel
        mesh, shape = self.mesh, self.mesh.shape
        per_ep = self.cfg.num_experts // ep
        experts = (mesh.coordinate(AXIS_EXPERT) * per_ep, per_ep)
        rows = shape[AXIS_DATA] * shape[AXIS_FSDP]
        n = rows * self.sp
        if n == 1:
            return MoEParallel(experts=experts)
        group = mesh.group(_BATCH_AXES)
        row = (mesh.coordinate(AXIS_DATA) * shape[AXIS_FSDP]
               + mesh.coordinate(AXIS_FSDP))
        col = mesh.coordinate(AXIS_SEQ)

        def gather_index(idx):
            import torch.distributed as dist
            b, s, k = idx.shape
            parts = [torch.empty((b, s, k), dtype=torch.int32,
                                 device=idx.device) for _ in range(n)]
            dist.all_gather(parts, idx.to(torch.int32).contiguous(),
                            group=group)
            whole = torch.stack(parts).reshape(rows, self.sp, b, s, k)
            return whole.transpose(1, 2).reshape(rows * b, self.sp * s,
                                                 k).long()

        def local_slots(whole):
            b, s = whole.shape[0] // rows, whole.shape[1] // self.sp
            return whole[row * b:(row + 1) * b, col * s:(col + 1) * s]

        return MoEParallel(token_group=group, token_ranks=n,
                           gather_index=gather_index,
                           local_slots=local_slots, experts=experts)

    def place_params(self, full):
        return _rebuild(full, {name: distribute(x, self.shardings[name])
                               for name, x in _named_leaves(full)})

    def place_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The whole batch (the same on every rank) as DTensors whose rows
        are split over (dp, fsdp) and, where sp > 1, whose positions are
        split over sp.  A split row's targets and default loss mask are
        built on the whole row first (JAX's loss shifts the whole row): a
        block's last position takes the next block's first token, and only
        the row's last position is masked."""
        batch = {k: _as_tensor(v) for k, v in batch.items()}
        if self.sp > 1:
            tokens = batch["tokens"]
            batch["targets"] = torch.cat(
                [tokens[:, 1:], torch.zeros_like(tokens[:, :1])], dim=1)
            if "loss_mask" not in batch:
                mask = torch.ones(tokens.shape, dtype=torch.float32)
                mask[:, -1] = 0.0
                batch["loss_mask"] = mask
        out = {}
        for k, t in batch.items():
            placements = (self.batch.placements if t.dim() else
                          (_replicate(),) * len(CANONICAL_ORDER))
            out[k] = distribute(t, NamedSharding(self.mesh, placements))
        return out

    def positions(self, local_batch) -> Optional[torch.Tensor]:
        """This rank's block of positions where sp splits them (RoPE takes
        the block's global positions)."""
        if self.sp == 1:
            return None
        s = local_batch["tokens"].shape[1]
        return (torch.arange(s, device=self.mesh.device)
                + self.mesh.coordinate(AXIS_SEQ) * s)

    def _gathered(self, params):
        """Each param's compute copy: a plain local tensor, gathered over
        every axis its compute placements replicate; a leaf of the local
        graph."""
        out = {}
        with torch.no_grad():
            for name, p in _named_leaves(params):
                local = p.redistribute(self.dm, self.compute[name]).to_local()
                # A collective still in flight: wait before a kernel reads
                # its memory by address.
                wait = getattr(local, "wait", None)
                local = wait() if wait is not None else local
                out[name] = local.detach().requires_grad_(True)
        return out

    def loss_and_grads(self, params, batch, grad_accum: int):
        from torch.distributed.tensor import DTensor, Partial
        local_batch = {k: v.to_local() for k, v in batch.items()}
        denom = self.loss_denom(batch, local_batch)
        gathered = self._gathered(params)
        tree = _rebuild(params, gathered)
        with L.parallel_groups(self.groups):
            loss, grads = _accumulated_grads(tree, local_batch, self.cfg,
                                             grad_accum, denom,
                                             self.positions(local_batch))
        # Partial sums over the batch axes, reduced onto each param's own
        # placements (reduce-scatter over fsdp, all-reduce over dp and sp).
        out = []
        for (name, p), g in zip(_named_leaves(params), grads):
            partial = tuple(
                Partial() if a in _BATCH_AXES else c
                for a, c in zip(CANONICAL_ORDER, self.compute[name]))
            g = DTensor.from_local(g, self.dm, partial,
                                   run_check=False, shape=p.shape,
                                   stride=p.stride())
            out.append(g.redistribute(self.dm, p.placements))
        return self._batch_sum(loss), out

    def eval_loss(self, params, batch) -> torch.Tensor:
        local = {k: v.to_local() for k, v in batch.items()}
        local["loss_denom"] = self.loss_denom(batch, local)
        tree = _rebuild(params, self._gathered(params))
        with L.parallel_groups(self.groups):
            return self._batch_sum(L.loss_fn(tree, local, self.cfg,
                                             self.positions(local)))

    def _batch_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of a per-rank partial over the batch axes, the same
        value on every rank (one all-reduce over their ranks)."""
        import torch.distributed as dist
        x = x.detach().clone()
        dist.all_reduce(x, group=self.mesh.group(_BATCH_AXES))
        return x

    def loss_denom(self, batch, local_batch) -> torch.Tensor:
        """The whole batch's unmasked token count, from the rows each rank
        holds."""
        if "loss_mask" not in batch:
            return _loss_denom(batch)
        return self._batch_sum(
            local_batch["loss_mask"].float().sum()).clamp_min(1.0)

    def blockwise_norm(self, params):
        """``global_norm`` of a tree of local blocks laid out as
        ``params``: each block counted once (by its primary replica),
        summed over every rank."""
        primary = [is_primary(p) for p in tree_leaves(params)]

        def norm(leaves):
            import torch.distributed as dist
            if len(leaves) != len(primary):
                raise ValueError(
                    f"global_norm on the mesh takes a tree laid out as the "
                    f"params ({len(primary)} leaves), got {len(leaves)}")
            total = torch.zeros((), dtype=torch.float32,
                                device=self.mesh.device)
            for t, first in zip(leaves, primary):
                if first:
                    total = total + torch.linalg.vector_norm(
                        t, dtype=torch.float32) ** 2
            dist.all_reduce(total)
            return total.sqrt()

        return norm

    def global_norm(self, grads) -> torch.Tensor:
        """sqrt of the sum of squares of every gradient leaf (laid out as
        the params), the same value on every rank."""
        return self.blockwise_norm(grads)([g.to_local() for g in grads])


def _replicate():
    from torch.distributed.tensor import Replicate
    return Replicate()


def _named_leaves(tree):
    """(leaf name, leaf) of a params-shaped tree, in tree_leaves order; a
    leaf's name is its key in the dict that holds it."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += _named_leaves(v) if isinstance(v, dict) else [(k, v)]
    return out


def _rebuild(tree, by_name: Dict[str, Any]):
    return {k: (_rebuild(v, by_name) if isinstance(v, dict) else by_name[k])
            for k, v in tree.items()}


def make_lm_eval_step(cfg, mesh: Mesh, *,
                      rules: Optional[ShardingRules] = None):
    """eval_step(params, batch) -> loss, without a graph; on a mesh of
    several ranks the same value on every rank."""
    L.check_supported(cfg)
    L.check_device_supported(cfg, mesh.device)
    if mesh.device_mesh is None:
        @torch.no_grad()
        def eval_step(params, batch):
            return L.loss_fn(params, batch, cfg)
        return eval_step
    plan = _ShardedPlan(cfg, mesh, rules or default_rules())

    @torch.no_grad()
    def sharded_eval_step(params, batch):
        return plan.eval_loss(params, batch)

    return sharded_eval_step
