"""The port's multi-device mesh and sharded training step against the JAX
package's, on the CPU.

``MeshSpec`` resolution and ``logical_to_placements`` are held to JAX's
``MeshSpec`` and ``logical_to_pspec`` directly.  The sharded step runs over
gloo process groups, one CPU process a rank (``parallel.launch.run_local``:
a ``file://`` rendezvous under ``tmp_path`` and a hard time limit), on the
meshes of JAX's ``TestShardedTrainStep`` (``tests/test_models.py``): two
adamw steps on ``llama_tiny`` in fp32 from JAX's initial weights give
losses within 2e-4 (relative) of the port's one-device step and of JAX's
sharded step on the same mesh.  Each rank also checks that mu and nu carry
their param's placements; the per-rank param bytes equal JAX's
``per_device_param_bytes`` on the same mesh; the port's init is bit-equal
on every mesh shape; the eval step and ``grad_accum`` work on the mesh.
"""

from __future__ import annotations

import hashlib
import importlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import llama as t_llama
from ray_tpu_torch.parallel import MeshSpec, build_mesh, make_lm_train_step
from ray_tpu_torch.parallel import mesh as t_mesh
from ray_tpu_torch.parallel import sharding as t_sharding
from ray_tpu_torch.parallel.launch import run_local

LR = 1e-2            # JAX's TestShardedTrainStep
B, S, STEPS = 8, 64, 2
LOSS_RTOL = 2e-4


def _jax():
    """JAX and the JAX package's modules, imported here and not at the top:
    each gloo rank imports this file to find its worker, and eight ranks
    importing JAX would take most of the test's time."""
    names = {"jax": "jax", "jnp": "jax.numpy",
             "j_llama": "ray_tpu.models.llama",
             "j_mesh": "ray_tpu.parallel.mesh",
             "j_sharding": "ray_tpu.parallel.sharding",
             "j_spmd": "ray_tpu.parallel.spmd",
             "j_runtime": "ray_tpu.train.mesh.runtime"}
    return type("J", (), {k: importlib.import_module(v)
                          for k, v in names.items()})


@pytest.mark.parametrize("kw,n", [
    ({}, 1), ({"dp": -1}, 8), ({"dp": 2, "fsdp": -1}, 8),
    ({"dp": 2, "fsdp": 2, "tp": 2}, 8), ({"fsdp": 4, "tp": -1}, 8),
    ({"pp": 2, "fsdp": 4}, 8), ({"dp": 4, "tp": 2, "num_slices": 2}, 8),
    ({"sp": -1, "ep": 2}, 6),
    # Errors: two -1 axes, a count the fixed axes do not divide, a size
    # that does not match.
    ({"dp": -1, "tp": -1}, 8), ({"dp": -1, "tp": 3}, 8), ({"dp": 2}, 8),
    ({"sp": 0}, 1)])
def test_mesh_spec_resolves_as_jax(kw, n):
    try:
        want = _jax().j_mesh.MeshSpec(**kw).resolved(n)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            MeshSpec(**kw).resolved(n)
        assert str(got.value) == str(e)
        return
    got = MeshSpec(**kw).resolved(n)
    assert got.shape() == want.shape()
    assert got.num_slices == want.num_slices
    assert t_mesh.CANONICAL_ORDER == tuple(a for a, _ in want.shape())


_RULES = {
    "default": {},
    # FSDP off, mlp over (fsdp, tp), vocab replicated.
    "mlp_2d": {"embed": None, "mlp": ("fsdp", "tp"), "vocab": None},
    # Heads over fsdp too (the first dim that names fsdp keeps it), batch
    # over dp alone.
    "heads_fsdp": {"heads": ("fsdp", "tp"), "batch": "dp",
                   "layers": "pp"},
}


def _as_placements(pspec, ndim):
    """A JAX PartitionSpec -> {mesh axis: sharded dim}."""
    out = {}
    for d, entry in enumerate(tuple(pspec) + (None,) * (ndim - len(pspec))):
        if entry is None:
            continue
        for a in ((entry,) if isinstance(entry, str) else entry):
            out[a] = d
    return out


@pytest.mark.parametrize("name", list(_RULES))
def test_logical_to_placements_matches_jax_pspec(name):
    J = _jax()
    j_sharding, j_llama = J.j_sharding, J.j_llama
    j_rules = j_sharding.default_rules().replace(**_RULES[name])
    t_rules = t_sharding.default_rules().replace(**_RULES[name])
    logical = t_llama.param_logical_axes(t_llama.llama_tiny())
    assert logical == j_llama.param_logical_axes(j_llama.llama_tiny())
    cases = [ax for ax in J.jax.tree.leaves(
        logical, is_leaf=lambda x: isinstance(x, tuple))]
    cases += [("batch", "seq"), ("batch", "seq", "embed")]
    for ax in cases:
        want = _as_placements(j_sharding.logical_to_pspec(ax, j_rules),
                              len(ax))
        got = t_sharding.logical_to_placements(ax, t_rules)
        assert len(got) == len(t_mesh.CANONICAL_ORDER)
        have = {a: p.dim for a, p in zip(t_mesh.CANONICAL_ORDER, got)
                if p.is_shard()}
        assert have == want, (ax, have, want)
    tree = t_sharding.pspec_pytree(logical, t_rules)
    assert tree["blocks"]["wq"] == t_sharding.logical_to_placements(
        logical["blocks"]["wq"], t_rules)


def _batches(cfg):
    rng = np.random.default_rng(7)
    return [{"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)} for _ in range(STEPS)]


def _digest(tree):
    from ray_tpu_torch._tree import tree_leaves
    h = hashlib.sha256()
    for t in tree_leaves(tree):
        h.update(t.detach().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _sharded_worker(rank, world, spec_kw, params_np, batches):
    """One rank's half of the test: the sharded trajectory from JAX's
    weights and everything the test checks beside it."""
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch import optim
    from ray_tpu_torch._tree import tree_leaves
    from ray_tpu_torch.parallel import make_lm_eval_step
    from ray_tpu_torch.train.mesh import runtime
    mesh = build_mesh(MeshSpec(**spec_kw))
    cfg = t_llama.llama_tiny().replace(dtype=torch.float32, remat=False)
    logical = t_llama.param_logical_axes(cfg)
    _init, step_fn, place = make_lm_train_step(cfg, mesh, learning_rate=LR)
    opt = optim.adamw(LR, b1=0.9, b2=0.95, weight_decay=0.1)

    def fresh():
        params = runtime.shard_tree(params_np, logical, mesh)
        return params, opt.init(params)

    params, state = fresh()
    nbytes = runtime.per_device_param_bytes(params)
    losses = []
    for b in batches:
        params, state, m = step_fn(params, state, place(b))
        losses.append((float(m["loss"]), float(m["grad_norm"])))
    same_layout = all(
        isinstance(p, DTensor) and p.placements == mu.placements
        == nu.placements
        for p, mu, nu in zip(tree_leaves(params), tree_leaves(state.mu),
                             tree_leaves(state.nu)))
    count_plain = not isinstance(state.count, DTensor)
    gathered = t_sharding.constrain(params["embed"], (None, None))
    constrained = (all(p.is_replicate() for p in gathered.placements)
                   and torch.equal(gathered.to_local(),
                                   params["embed"].full_tensor()))
    evaluated = float(make_lm_eval_step(cfg, mesh)(params,
                                                   place(batches[0])))
    # grad_accum: one step from the same weights, in two microbatches.
    _i, accum_step, _p = make_lm_train_step(cfg, mesh, learning_rate=LR,
                                            grad_accum=2)
    p2, s2 = fresh()
    accum = accum_step(p2, s2, place(batches[0]))[2]
    # The port's own init, gathered whole.
    init_fn, *_ = make_lm_train_step(cfg, mesh, learning_rate=LR)
    p0, _s0 = init_fn(torch.Generator().manual_seed(3))
    full = {k: (v.full_tensor() if k != "blocks" else
                {n: w.full_tensor() for n, w in v.items()})
            for k, v in p0.items()}
    return {"losses": losses, "bytes": list(nbytes.values())[0],
            "same_layout": same_layout, "count_plain": count_plain,
            "constrained": constrained,
            "eval": evaluated, "accum": (float(accum["loss"]),
                                         float(accum["grad_norm"])),
            "init": _digest(full), "slice": mesh.slice_index}


def _one_device(params_np, batches):
    from ray_tpu_torch import optim
    from ray_tpu_torch.models import convert
    from ray_tpu_torch.parallel import make_lm_eval_step
    cfg = t_llama.llama_tiny().replace(dtype=torch.float32, remat=False)
    mesh = build_mesh(device="cpu")
    _init, step_fn, place = make_lm_train_step(cfg, mesh, learning_rate=LR)
    params = convert.params_from_numpy(params_np, device="cpu")
    state = optim.adamw(LR).init(params)
    losses = []
    for b in batches:
        params, state, m = step_fn(params, state, place(b))
        losses.append((float(m["loss"]), float(m["grad_norm"])))
    init_fn, *_ = make_lm_train_step(cfg, mesh, learning_rate=LR)
    init = _digest(init_fn(torch.Generator().manual_seed(3))[0])
    evaluated = float(make_lm_eval_step(cfg, mesh)(params, place(
        batches[0])))
    return losses, init, evaluated


@pytest.fixture(scope="module")
def reference():
    """JAX's initial weights (numpy), the batches, and the port's
    one-device trajectory, init digest and eval loss from them."""
    J = _jax()
    cfg = J.j_llama.llama_tiny().replace(dtype=J.jnp.float32, remat=False)
    params = J.j_llama.init_params(cfg, J.jax.random.key(0))
    params_np = J.jax.tree.map(np.asarray, params)
    batches = _batches(cfg)
    return params_np, batches, _one_device(params_np, batches)


def _jax_run(spec_kw, params_np, batches):
    """JAX's sharded trajectory from the same weights on the same mesh,
    and its per-device param bytes in mesh order."""
    J = _jax()
    cfg = J.j_llama.llama_tiny().replace(dtype=J.jnp.float32, remat=False)
    world = int(np.prod([v for k, v in spec_kw.items()
                         if k != "num_slices"]))
    mesh = J.j_mesh.build_mesh(J.j_mesh.MeshSpec(**spec_kw),
                               devices=J.jax.devices()[:world])
    init_fn, step_fn, place = J.j_spmd.make_lm_train_step(
        cfg, mesh, learning_rate=LR)
    _p, opt = init_fn(J.jax.random.key(0))
    params = J.j_runtime.shard_tree(
        params_np, J.j_llama.param_logical_axes(cfg), mesh)
    per_dev = J.j_runtime.per_device_param_bytes(params)
    losses = []
    for b in batches:
        params, opt, m = step_fn(params, opt, place(b))
        losses.append(float(m["loss"]))
    return losses, [per_dev[str(d)] for d in mesh.devices.flat]


@pytest.mark.parametrize("spec_kw", [
    {"dp": 2}, {"fsdp": 2}, {"tp": 2}, {"dp": 2, "fsdp": 2},
    {"dp": 2, "fsdp": 2, "tp": 2}, {"dp": 4, "tp": 2, "num_slices": 2}],
    ids=["dp2", "fsdp2", "tp2", "dp2xfsdp2", "dp2xfsdp2xtp2",
         "dp4xtp2x2slices"])
def test_sharded_step_matches_one_device_and_jax(tmp_path, reference,
                                                 spec_kw):
    params_np, batches, (one_losses, one_init, one_eval) = reference
    world = int(np.prod([v for k, v in spec_kw.items()
                         if k != "num_slices"]))
    # The ranks run while JAX compiles and runs its side here.
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_local, _sharded_worker, world, str(tmp_path),
                            spec_kw, params_np, batches, timeout=150)
        j_losses, j_bytes = _jax_run(spec_kw, params_np, batches)
        ranks = ranks.result()
    for rank, r in enumerate(ranks):
        got = np.array([x[0] for x in r["losses"]])
        np.testing.assert_allclose(got, [x[0] for x in one_losses],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(got, j_losses, rtol=LOSS_RTOL)
        np.testing.assert_allclose([x[1] for x in r["losses"]],
                                   [x[1] for x in one_losses],
                                   rtol=LOSS_RTOL)
        # Every rank holds the same replicated metrics.
        assert r["losses"] == ranks[0]["losses"]
        assert r["same_layout"] and r["count_plain"] and r["constrained"]
        assert r["init"] == one_init
        np.testing.assert_allclose(r["eval"], one_eval, rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["accum"], ranks[0]["losses"][0],
                                   rtol=LOSS_RTOL)
        assert r["slice"] == (rank // (world // spec_kw.get("dp", 1))
                              // (spec_kw.get("dp", 1)
                                  // spec_kw.get("num_slices", 1)))
    assert [r["bytes"] for r in ranks] == j_bytes
