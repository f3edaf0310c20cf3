"""The port's sequence parallelism (``ray_tpu_torch.ops.ring_attention``,
``ops.ulysses`` and the sp axis of the sharded step) against the JAX
package's, on the CPU.

Ring attention (causal and full, GQA) and Ulysses attention over four gloo
ranks, forward and gradients, against JAX's ``ring_attention_sharded`` and
``ulysses_attention_sharded`` on a four-device sp mesh; the ring's steps
over blocks of one process (``ring_attention_local``) against plain
attention; the shifted targets and default loss mask of a split row built
on the whole row, and RoPE at the block's global positions; and the
sharded step on JAX's ``dp2 x sp4`` ring and ``dp2 x sp2 x tp2`` Ulysses
meshes (``tests/test_models.py``'s ``TestShardedTrainStep``) and on a
``dp2 x fsdp2 x sp2`` mesh with plain attention, against JAX's on the same
mesh and the port's one device.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import _torch_parallel as par
from ray_tpu_torch.ops import ulysses as t_ulysses
from ray_tpu_torch.ops.attention import reference_attention
from ray_tpu_torch.ops.ring_attention import (ring_attention,
                                              ring_attention_local)
from ray_tpu_torch.parallel.launch import run_local

TOL = 1e-5
# (name, kind, causal, H, Hkv): four ranks, S 32 (8 a rank), D 16.
CASES = [("ring_causal_gqa", "ring", True, 4, 2),
         ("ring_full_gqa", "ring", False, 4, 2),
         ("ulysses_causal", "ulysses", True, 8, 8),
         ("ulysses_causal_gqa", "ulysses", True, 8, 2)]
N = 4


def _qkv(H, Hkv, seed, B=2, S=32, D=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, H, S, D), (B, Hkv, S, D), (B, Hkv, S, D),
                          (B, H, S, D))]


def _attn_worker(rank, world):
    """Every case's forward and gradients on this rank's sequence
    block."""
    import torch.distributed as dist
    group = dist.new_group(list(range(world)))
    out = {}
    for i, (name, kind, causal, H, Hkv) in enumerate(CASES):
        q, k, v, do = _qkv(H, Hkv, i)
        sl = slice(rank * q.shape[2] // world,
                   (rank + 1) * q.shape[2] // world)
        ts = [torch.tensor(a[:, :, sl], requires_grad=True)
              for a in (q, k, v)]
        fn = (ring_attention if kind == "ring"
              else t_ulysses.ulysses_attention)
        o = fn(*ts, group=group, causal=causal)
        grads = torch.autograd.grad(o, ts, torch.tensor(do[:, :, sl]))
        out[name] = [o.detach().numpy()] + [g.numpy() for g in grads]
    return out


@pytest.fixture(scope="module")
def port_attention(tmp_path_factory):
    ranks = run_local(_attn_worker, N, str(tmp_path_factory.mktemp("rdv")),
                      timeout=90)
    return {name: [np.concatenate([r[name][i] for r in ranks], 2)
                   for i in range(4)] for name, *_ in CASES}


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_matches_jax_sharded(port_attention, case):
    import jax
    import jax.numpy as jnp

    from ray_tpu.ops.ring_attention import ring_attention_sharded
    from ray_tpu.ops.ulysses import ulysses_attention_sharded
    from ray_tpu.parallel.mesh import MeshSpec, build_mesh
    name, kind, causal, H, Hkv = case
    q, k, v, do = _qkv(H, Hkv, CASES.index(case))
    mesh = build_mesh(MeshSpec(sp=N), devices=jax.devices()[:N])
    fn = (ring_attention_sharded if kind == "ring"
          else ulysses_attention_sharded)

    def f(q, k, v):
        return fn(q, k, v, mesh, causal=causal)

    out, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    want = [out] + list(vjp(jnp.asarray(do)))
    for got, w in zip(port_attention[name], want):
        w = np.asarray(w)
        np.testing.assert_allclose(got, w, rtol=TOL,
                                   atol=TOL * np.abs(w).max())


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ring_steps_in_one_process_match_plain(causal):
    q, k, v, do = (torch.tensor(a) for a in _qkv(4, 2, 9))
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ring_attention_local(*ts, N, causal=causal)
    grads = torch.autograd.grad(out, ts, do)
    rs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = reference_attention(*rs, causal=causal)
    want = torch.autograd.grad(ref, rs, do)
    for got, w in zip((out,) + grads, (ref,) + want):
        torch.testing.assert_close(got, w, rtol=TOL, atol=TOL)


def test_ulysses_refuses_heads_the_group_does_not_divide(tmp_path):
    import jax
    import jax.numpy as jnp

    from ray_tpu.ops.ulysses import ulysses_attention_sharded
    from ray_tpu.parallel.mesh import MeshSpec, build_mesh
    q, k, v, _ = _qkv(3, 3, 0)
    mesh = build_mesh(MeshSpec(sp=2), devices=jax.devices()[:2])
    with pytest.raises(ValueError) as want:
        ulysses_attention_sharded(*map(jnp.asarray, (q, k, v)), mesh)
    got = run_local(_refusal_worker, 2, str(tmp_path), q, k, v, timeout=60)
    assert got == [str(want.value)] * 2


def _refusal_worker(rank, world, q, k, v):
    import torch.distributed as dist
    group = dist.new_group(list(range(world)))
    try:
        t_ulysses.ulysses_attention(*map(torch.tensor, (q, k, v)),
                                    group=group)
    except ValueError as e:
        return str(e)
    return None


def _split_row_worker(rank, world, tokens):
    """This rank's block of a row split over sp: its targets, mask and
    positions; the loss from them; and the per-block shift's loss."""
    from ray_tpu_torch.models import llama as t_llama
    from ray_tpu_torch.parallel import MeshSpec, build_mesh
    from ray_tpu_torch.parallel.spmd import _ShardedPlan
    from ray_tpu_torch.parallel.sharding import default_rules
    mesh = build_mesh(MeshSpec(sp=world))
    cfg = t_llama.llama_tiny().replace(dtype=torch.float32, remat=False)
    plan = _ShardedPlan(cfg, mesh, default_rules())
    batch = plan.place_batch({"tokens": tokens})
    local = {k: v.to_local() for k, v in batch.items()}
    params = t_llama.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    with t_llama.parallel_groups(plan.groups), torch.no_grad():
        shifted_here = plan._batch_sum(t_llama.loss_fn(
            params, {"tokens": local["tokens"],
                     "loss_denom": plan.loss_denom(batch, local)}, cfg,
            plan.positions(local)))
    full = plan.eval_loss(plan.place_params(params), batch)
    return ({k: v.numpy() for k, v in local.items()},
            plan.positions(local).numpy(), float(full), float(shifted_here))


def test_split_rows_shift_on_the_whole_row(tmp_path):
    """A block's last target is the next block's first token; only the
    row's last position is masked; RoPE takes the block's global
    positions; the loss equals one device's.  Shifting within each block
    (the per-rank version) gives another loss."""
    from ray_tpu_torch.models import llama as t_llama
    tokens = np.random.default_rng(2).integers(0, 512, (2, 16)).astype(
        np.int32)
    ranks = run_local(_split_row_worker, 2, str(tmp_path), tokens,
                      timeout=60)
    (b0, p0, full, per_block), (b1, p1, _f, _p) = ranks
    assert (b0["targets"][:, -1] == tokens[:, 8]).all()
    np.testing.assert_array_equal(
        np.concatenate([b0["targets"], b1["targets"]], 1)[:, :-1],
        tokens[:, 1:])
    assert b0["loss_mask"].all() and b1["loss_mask"][:, :-1].all()
    assert not b1["loss_mask"][:, -1].any()
    np.testing.assert_array_equal(np.concatenate([p0, p1]), np.arange(16))
    cfg = t_llama.llama_tiny().replace(dtype=torch.float32, remat=False)
    params = t_llama.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    with torch.no_grad():
        one = t_llama.loss_fn(params, {"tokens": torch.from_numpy(tokens)},
                              cfg).item()
    np.testing.assert_allclose(full, one, rtol=1e-6)
    assert abs(per_block - one) > 1e-3


@pytest.mark.parametrize("spec_kw,cfg_kw", [
    ({"dp": 2, "sp": 4}, {"attention_impl": "ring"}),
    ({"dp": 2, "sp": 2, "tp": 2}, {"attention_impl": "ulysses"}),
    ({"dp": 2, "fsdp": 2, "sp": 2}, {})],
    ids=["dp2xsp4_ring", "dp2xsp2xtp2_ulysses", "dp2xfsdp2xsp2_gathered"])
def test_sharded_step_matches_jax_and_one_device(tmp_path, spec_kw, cfg_kw):
    par.check_mesh(tmp_path, spec_kw, cfg_kw)
