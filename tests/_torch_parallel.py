"""Shared by the port's sequence-, expert- and pipeline-parallel tests: one
sharded training run of the port over gloo ranks, JAX's sharded run on the
same mesh from the same weights, and the port's one-device run.

``check_mesh`` runs all three on ``llama_tiny`` in fp32 (remat off, adamw
at lr 1e-2 as JAX's ``TestShardedTrainStep``), two steps on seeded
batches, and holds the port's losses on the mesh within ``LOSS_RTOL`` of
JAX's on the same mesh and of the port's one-device losses, its grad norms
and eval loss within it of the one-device run's, and every rank to the
same metrics.  A pipeline config's one-device run leaves the pipeline out
(JAX refuses it without a pp mesh; ``tests/test_pipeline.py`` holds JAX's
pipeline to its plain forward the same way).

JAX is imported inside the functions: every gloo rank imports the test
file that names its worker, and eight ranks importing JAX would take most
of a test's time.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

LR = 1e-2
STEPS = 2
LOSS_RTOL = 2e-4


def _rules(cfg_kw, module):
    rules = module.default_rules()
    return rules.replace(layers="pp") if cfg_kw.get("pp_microbatches") \
        else rules


def jax_weights(cfg_kw):
    """JAX's initial llama_tiny weights (numpy) for ``cfg_kw``."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import llama as j_llama
    cfg = j_llama.llama_tiny().replace(dtype=jnp.float32, remat=False,
                                       **cfg_kw)
    return jax.tree.map(np.asarray,
                        j_llama.init_params(cfg, jax.random.key(0)))


def batches(B, S, seed=7):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, 512, (B, S)).astype(np.int32)}
            for _ in range(STEPS)]


def _port_cfg(cfg_kw):
    from ray_tpu_torch.models import llama as t_llama
    return t_llama.llama_tiny().replace(**dict(
        dict(dtype=torch.float32, remat=False), **cfg_kw))


def _port_run(mesh, cfg_kw, params, data):
    from ray_tpu_torch import optim
    from ray_tpu_torch.parallel import make_lm_eval_step, make_lm_train_step
    cfg = _port_cfg(cfg_kw)
    _i, step_fn, place = make_lm_train_step(cfg, mesh, learning_rate=LR)
    state = optim.adamw(LR, b1=0.9, b2=0.95, weight_decay=0.1).init(params)
    metrics = []
    for b in data:
        params, state, m = step_fn(params, state, place(b))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return {"metrics": metrics,
            "eval": float(make_lm_eval_step(cfg, mesh)(params,
                                                       place(data[0])))}


def rank_worker(rank, world, spec_kw, cfg_kw, params_np, data):
    """One gloo rank: the port's sharded run from JAX's weights."""
    from ray_tpu_torch.models import llama as t_llama
    from ray_tpu_torch.parallel import MeshSpec, build_mesh
    from ray_tpu_torch.parallel import sharding as t_sharding
    from ray_tpu_torch.train.mesh import runtime
    mesh = build_mesh(MeshSpec(**spec_kw))
    cfg = _port_cfg(cfg_kw)
    params = runtime.shard_tree(params_np, t_llama.param_logical_axes(cfg),
                                mesh, _rules(cfg_kw, t_sharding))
    return _port_run(mesh, cfg_kw, params, data)


def one_device(cfg_kw, params_np, data):
    from ray_tpu_torch.models import convert
    from ray_tpu_torch.parallel import build_mesh
    kw = {k: v for k, v in cfg_kw.items() if k != "pp_microbatches"}
    return _port_run(build_mesh(device="cpu"), kw,
                     convert.params_from_numpy(params_np, device="cpu"),
                     data)


def jax_losses(spec_kw, cfg_kw, params_np, data):
    """JAX's sharded losses from the same weights on the same mesh."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import llama as j_llama
    from ray_tpu.parallel import mesh as j_mesh
    from ray_tpu.parallel import sharding as j_sharding
    from ray_tpu.parallel import spmd as j_spmd
    from ray_tpu.train.mesh import runtime as j_runtime
    cfg = j_llama.llama_tiny().replace(dtype=jnp.float32, remat=False,
                                       **cfg_kw)
    world = int(np.prod(list(spec_kw.values())))
    mesh = j_mesh.build_mesh(j_mesh.MeshSpec(**spec_kw),
                             devices=jax.devices()[:world])
    init_fn, step_fn, place = j_spmd.make_lm_train_step(
        cfg, mesh, learning_rate=LR)
    _p, opt = init_fn(jax.random.key(0))
    params = j_runtime.shard_tree(params_np,
                                  j_llama.param_logical_axes(cfg), mesh,
                                  _rules(cfg_kw, j_sharding))
    losses = []
    for b in data:
        params, opt, m = step_fn(params, opt, place(b))
        losses.append(float(m["loss"]))
    return losses


def check_mesh(tmp_path, spec_kw, cfg_kw, B=8, S=64, timeout=150):
    """Run the three and hold them together (see the module docstring);
    returns the ranks' results."""
    from ray_tpu_torch.parallel.launch import run_local
    params_np = jax_weights(cfg_kw)
    data = batches(B, S)
    world = int(np.prod(list(spec_kw.values())))
    # The ranks run while JAX compiles and runs its side here.
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_local, rank_worker, world, str(tmp_path),
                            spec_kw, cfg_kw, params_np, data,
                            timeout=timeout)
        want = jax_losses(spec_kw, cfg_kw, params_np, data)
        one = one_device(cfg_kw, params_np, data)
        ranks = ranks.result()
    for r in ranks:
        assert r == ranks[0]
        got = [m[0] for m in r["metrics"]]
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["metrics"], one["metrics"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["eval"], one["eval"], rtol=LOSS_RTOL)
    return ranks
