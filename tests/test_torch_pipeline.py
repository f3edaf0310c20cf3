"""The port's pipeline parallelism (``ray_tpu_torch.parallel.pipeline`` and
the pp axis of the sharded step) against the JAX package's, on the CPU.

The sharded step with ``pp_microbatches`` 4 on JAX's ``pp2 x dp2 x tp2``
and ``pp4 x dp2`` meshes (``tests/test_pipeline.py``), against JAX's
pipeline on the same mesh and the port's one device without a pipeline;
and, under full remat, the layer leaves split over pp at rest, every pp
rank's replicated leaves (embed, final_norm, lm_head) getting the same
gradient, and the step equal to one device's.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import _torch_parallel as par
from ray_tpu_torch.parallel.launch import run_local

MESHES = [{"pp": 2, "dp": 2, "tp": 2}, {"pp": 4, "dp": 2}]


@pytest.mark.parametrize("spec_kw", MESHES, ids=["pp2xdp2xtp2", "pp4xdp2"])
def test_sharded_step_matches_jax_and_one_device(tmp_path, spec_kw):
    par.check_mesh(tmp_path, spec_kw, {"pp_microbatches": 4, "layers": 4})


def _remat_worker(rank, world, params_np, data):
    from ray_tpu_torch.models import llama as t_llama
    from ray_tpu_torch.parallel import MeshSpec, build_mesh
    from ray_tpu_torch.parallel.sharding import default_rules
    from ray_tpu_torch.parallel.spmd import _ShardedPlan, _named_leaves
    from ray_tpu_torch.train.mesh import runtime
    mesh = build_mesh(MeshSpec(pp=2, dp=2))
    cfg = t_llama.llama_tiny().replace(dtype=torch.float32, remat=True,
                                       pp_microbatches=2, layers=4)
    rules = default_rules().replace(layers="pp")
    params = runtime.shard_tree(params_np, t_llama.param_logical_axes(cfg),
                                mesh, rules)
    plan = _ShardedPlan(cfg, mesh, default_rules())
    batch = plan.place_batch(data[0])
    loss, grads = plan.loss_and_grads(params, batch, 1)
    replicated = {name: g.to_local().numpy()
                  for (name, _p), g in zip(_named_leaves(params), grads)
                  if name in ("embed", "final_norm", "lm_head")}
    wq = params["blocks"]["wq"]
    return {"wq_placement_pp": str(wq.placements[0]),
            "wq_local_layers": wq.to_local().shape[0],
            "replicated_grads": replicated, "loss": float(loss),
            "grad_norm": float(plan.global_norm(grads))}


def test_remat_layers_split_and_replicated_grads_agree(tmp_path):
    kw = {"pp_microbatches": 2, "layers": 4}
    params_np = par.jax_weights(kw)
    data = par.batches(8, 64)
    ranks = run_local(_remat_worker, 4, str(tmp_path), params_np, data,
                      timeout=90)
    one = par.one_device(dict(kw, remat=True), params_np, data[:1])
    for r in ranks:
        assert r["wq_placement_pp"] == "S(0)" and r["wq_local_layers"] == 2
        np.testing.assert_allclose([r["loss"], r["grad_norm"]],
                                   one["metrics"][0], rtol=par.LOSS_RTOL)
    # pp ranks 0 and 1 of each dp index (ranks r and r + 2) hold the same
    # replicated gradients, bit for bit.
    for a, b in ((0, 2), (1, 3)):
        for name, g in ranks[a]["replicated_grads"].items():
            assert np.array_equal(g, ranks[b]["replicated_grads"][name]), \
                name
