"""The port's mixture-of-experts layers (``ray_tpu_torch.ops.moe`` and the
MoE blocks of ``models.llama``) against the JAX package's, on the CPU.

``moe_layer`` (sorted capacity dispatch, with and without drops, and dense
dispatch), its output, aux loss and every gradient, within 1e-5 of
``ray_tpu/ops/moe.py`` on the same inputs; the routing and both dispatch
plans exactly; the MoE model's loss and gradients under every remat mode
against JAX's ``loss_fn``; the "dots" policy saving the expert products
that "dots_nobatch" recomputes; the load-balancing loss of a batch split
over ranks equal to the whole batch's; and the sharded step on JAX's
``dp2 x ep4`` mesh (``tests/test_models.py``'s ``test_moe_ep``) and on a
``dp2 x ep2 x tp2`` one against JAX's on the same mesh and the port's one
device.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import _torch_parallel as par
from ray_tpu_torch.ops import moe as t_moe
from ray_tpu_torch.parallel.launch import run_local

TOL = 1e-5


def _inputs(seed=0, B=2, S=16, E=32, X=4, M=48):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) * s
            for shape, s in (((B, S, E), 1.0), ((E, X), 0.3),
                             ((X, E, M), 0.2), ((X, E, M), 0.2),
                             ((X, M, E), 0.2))]


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=TOL,
                               atol=TOL * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5, 0.0],
                         ids=["sorted", "sorted_drops", "dense"])
def test_moe_layer_matches_jax(capacity_factor):
    import jax
    import jax.numpy as jnp

    from ray_tpu.ops import moe as j_moe
    arrays = _inputs()

    def j_loss(*a):
        out, aux = j_moe.moe_layer(*a, k=2, capacity_factor=capacity_factor)
        return jnp.sum(out * jnp.cos(out)) + aux, (out, aux)

    (_, (j_out, j_aux)), j_grads = jax.value_and_grad(
        j_loss, argnums=tuple(range(5)), has_aux=True)(
        *map(jnp.asarray, arrays))
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out, aux = t_moe.moe_layer(*ts, k=2, capacity_factor=capacity_factor)
    grads = torch.autograd.grad((out * torch.cos(out)).sum() + aux, ts)
    _close(out.detach(), j_out)
    _close(aux.detach(), j_aux)
    for g, jg in zip(grads, j_grads):
        _close(g, jg)
    if capacity_factor == 0.5:
        # Drops happen: some assignment has no slot.
        info = t_moe.top_k_routing(ts[0], ts[1])
        C = t_moe.capacity(32, 2, 0.5, 4)
        assert not t_moe.sorted_dispatch(info, 4, C)[4].all()


def test_routing_and_dispatch_plans_match_jax():
    import jax.numpy as jnp

    from ray_tpu.ops import moe as j_moe
    x, rw = _inputs(1)[:2]
    j_info = j_moe.top_k_routing(jnp.asarray(x), jnp.asarray(rw), k=2)
    t_info = t_moe.top_k_routing(torch.tensor(x), torch.tensor(rw), k=2)
    for got, want in zip(t_info, j_info):
        _close(got, want)
    assert np.array_equal(t_info.expert_index.numpy(),
                          np.asarray(j_info.expert_index))
    _close(t_moe.load_balancing_loss(t_info, 4),
           j_moe.load_balancing_loss(j_info, 4))
    for C in (4, 9, 32):
        for got, want in zip(t_moe.capacity_dispatch(t_info, 4, C),
                             j_moe.capacity_dispatch(j_info, 4, C)):
            _close(got, want)
        got = t_moe.sorted_dispatch(t_info, 4, C)
        want = j_moe.sorted_dispatch(j_info, 4, C)
        for name, a, b in zip(("tok", "e", "slot", "w", "keep"), got, want):
            if name == "w":
                _close(a, b)
            else:
                assert np.array_equal(a.numpy(), np.asarray(b)), name


def test_sorted_without_drops_equals_dense():
    ts = [torch.tensor(a) for a in _inputs(2)]
    # Capacity factor X / k: every expert has a slot for every token.
    sparse, aux_s = t_moe.moe_layer(*ts, k=2, capacity_factor=2.0)
    dense, aux_d = t_moe.moe_layer(*ts, k=2, capacity_factor=0.0)
    torch.testing.assert_close(sparse, dense, rtol=1e-5, atol=1e-5)
    assert float(aux_s) == float(aux_d)


REMATS = [False, True, "mlp_only", "dots", "dots_nobatch"]


@pytest.mark.parametrize("remat", REMATS, ids=[str(r) for r in REMATS])
def test_moe_model_loss_and_grads_match_jax(remat):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import llama as j_llama
    from ray_tpu_torch._tree import tree_leaves
    from ray_tpu_torch.models import convert
    from ray_tpu_torch.models import llama as t_llama
    kw = dict(num_experts=4, remat=remat)
    j_cfg = j_llama.llama_tiny().replace(dtype=jnp.float32, **kw)
    params = j_llama.init_params(j_cfg, jax.random.key(0))
    tokens = np.random.default_rng(3).integers(0, 512, (2, 32)).astype(
        np.int32)
    j_loss, j_grads = jax.value_and_grad(j_llama.loss_fn)(
        params, {"tokens": jnp.asarray(tokens)}, j_cfg)
    t_cfg = t_llama.llama_tiny().replace(dtype=torch.float32, **kw)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                   device="cpu")
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    loss = t_llama.loss_fn(tp, {"tokens": torch.from_numpy(tokens)}, t_cfg)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    for g, jg in zip(grads, jax.tree.leaves(j_grads)):
        _close(g, jg)


def _saved_products(mode):
    """The batch sizes of the bmm outputs ``mode``'s policy saves in one
    MoE block's forward."""
    from ray_tpu_torch.models import llama as t_llama
    policy = t_llama.remat_policy(mode)
    batches = []

    def recording(ctx, op, *args, **kw):
        decision = policy(ctx, op, *args, **kw)
        if (decision == t_llama.CheckpointPolicy.MUST_SAVE
                and op in t_llama._BATCHED_PRODUCTS):
            batches.append(args[op is torch.ops.aten.baddbmm.default]
                           .shape[0])
        return decision

    cfg = t_llama.llama_tiny().replace(dtype=torch.float32, num_experts=4,
                                       remat=mode, layers=1,
                                       attention_impl="reference")
    params = t_llama.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    for t in params["blocks"].values():
        t.requires_grad_(True)
    real = t_llama.remat_policy
    t_llama.remat_policy = lambda _mode: recording
    try:
        t_llama.loss_fn(params, {"tokens": torch.zeros(2, 16,
                                                       dtype=torch.long)},
                        cfg).backward()
    finally:
        t_llama.remat_policy = real
    return batches


def test_dots_saves_expert_products_and_dots_nobatch_does_not():
    """The expert products are bmms over the X experts: "dots" keeps
    them, "dots_nobatch" (batch-free products only) recomputes them."""
    dots, nobatch = _saved_products("dots"), _saved_products("dots_nobatch")
    assert dots.count(4) == 3          # gate, up, down: batch X = 4
    assert all(b == 1 for b in nobatch)


def _aux_worker(rank, world, arrays):
    """Each rank's share of the aux loss and its router gradient, from its
    half of the batch, with routing over both ranks' tokens."""
    import torch.distributed as dist
    x, rw, wg, wu, wd = arrays
    b = x.shape[0] // world
    ts = [torch.tensor(x[rank * b:(rank + 1) * b])] + [
        torch.tensor(a, requires_grad=True) for a in (rw, wg, wu, wd)]
    group = dist.new_group(list(range(world)))

    def gather(idx):
        parts = [torch.empty_like(idx, dtype=torch.int32)
                 for _ in range(world)]
        dist.all_gather(parts, idx.int(), group=group)
        return torch.cat(parts).long()

    parallel = t_moe.MoEParallel(
        token_group=group, token_ranks=world, gather_index=gather,
        local_slots=lambda whole: whole[rank * b:(rank + 1) * b])
    out, aux = t_moe.moe_layer(*ts, k=2, capacity_factor=0.5,
                               parallel=parallel)
    g_router = torch.autograd.grad(aux, ts[1])[0]
    local = t_moe.moe_layer(*ts, k=2, capacity_factor=0.5)[1]
    return (out.detach().numpy(), float(aux), g_router.numpy(),
            float(local))


def test_aux_loss_and_drops_are_the_whole_batchs(tmp_path):
    """Split over two ranks, the ranks' aux shares sum to the whole
    batch's loss and their router gradients to its gradient, and the
    outputs (drops decided over the whole batch) are the whole batch's.
    The per-rank version (each rank's own loss, averaged) differs."""
    arrays = _inputs(4, B=4, S=8)
    arrays[0][2:] += 1.5        # the halves route differently
    ranks = run_local(_aux_worker, 2, str(tmp_path), arrays, timeout=60)
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out, aux = t_moe.moe_layer(*ts, k=2, capacity_factor=0.5)
    g_router = torch.autograd.grad(aux, ts[1])[0]
    _close(np.concatenate([r[0] for r in ranks]), out.detach())
    _close(sum(r[1] for r in ranks), aux.detach())
    _close(sum(r[2] for r in ranks), g_router)
    per_rank = np.mean([r[3] for r in ranks])
    assert abs(per_rank - float(aux)) > 1e-3 * float(aux)


@pytest.mark.parametrize("spec_kw", [{"dp": 2, "ep": 4},
                                     {"dp": 2, "ep": 2, "tp": 2}],
                         ids=["dp2xep4", "dp2xep2xtp2"])
def test_sharded_moe_step_matches_jax_and_one_device(tmp_path, spec_kw):
    par.check_mesh(tmp_path, spec_kw, {"num_experts": 4})
