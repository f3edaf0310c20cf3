#!/usr/bin/env python3
"""The port's sharded training step on the NVIDIA cards of one host.

    python3 sharded_smoke.py           # every visible card, 2 or more
    python3 sharded_smoke.py --cpu     # rehearsal: 4 gloo ranks on the CPU
    python3 sharded_smoke.py --fit     # only the trainer run (4 cards)
    python3 sharded_smoke.py --collective   # only the NCCL collective group
    python3 sharded_smoke.py --fleet   # only the serving fleet, a replica a card
    python3 sharded_smoke.py --elastic # only the elastic trainer run (4 cards)

Run from the root of a checkout on a machine with two or more CUDA cards
and nvcc.  It builds the kernels, then for each run of ``RUNS`` trains 4
adamw steps with ``make_lm_train_step`` on one card, and the same 4 steps
from the same init and batches sharded over the cards through
``torch.distributed`` (NCCL, one process a card).  bf16 params and adam
state, full remat, flash attention.  The configs (``CONFIGS``):

- ``dense``: the 1.36B config of ``bench.py:3384-3390``, batch 8 x 2048;
  meshes fsdp4, dp2 x fsdp2, dp2 x tp2, and pp2 x fsdp2 with
  ``pp_microbatches`` 4 (the GPipe schedule over pp);
- ``long``: the same config at ``max_seq_len`` 8192, batch 2 x 8192; ring
  and Ulysses attention over sp4 (2,048 positions a rank);
- ``moe``: ``chip_smoke.py``'s ``train_moe`` config (llama_1b's widths and
  depth, 8 experts, top-2, capacity factor 1.25), batch 4 x 2048, over
  dp2 x ep2.

Each run's losses and grad norms are held to its config's one-card run
(``TOL_TRAIN_BF16``: bf16 sums in another order and another split).  It
reports each run's step ms (the median of steps 2-4, host clock around a
synchronize), tokens/s, every rank's param bytes and peak memory, and the
flash kernels' launches on each rank.

Then, on four cards, the trainer (``fit``): ``TorchTrainer`` with four
workers on ``MeshConfig(fsdp=4)`` trains ``chip_smoke.py``'s
``checkpoint`` config (the dense config's width at 4 layers, batch 4 x
2048) with async sharded saves; rank 2 dies after a committed save, the
group restarts and resumes from it; a second ``fit`` resumes the last save
onto dp2 x fsdp2 (a mesh reshape, each rank reading only its blocks).
Every step's loss is held to ``TOL`` of the same steps run on one card in
this process.

``--collective`` runs only the collective group of ``ray_tpu_torch.
collective`` over NCCL: one process actor a card, each joining
``init_collective_group(backend="nccl")``; allreduce, allgather, broadcast,
reducescatter and send/recv (rank pairs) held to numpy, and 10 allreduces
of 4 MiB timed on the host clock (each op copies its numpy array to the
card and back).  ``--cpu --collective`` runs it on 4 CPU actors over gloo.

``--fleet`` runs only the serving fleet across the cards: the prefill tier
in this process on card 0 and one ``RemoteReplica`` process a card, each
seeing its own card first and the others after it
(``CUDA_VISIBLE_DEVICES``), so a handoff's IPC handles open on the peer
card and its ``write_prefill`` scatter reads card 0's memory over NVLink.
``chip_smoke.py``'s exactness prompts (``REMOTE_EXACT``), each prefilled
once and imported by every card's replica alone, must give every card the
tokens of card 0's replica; then ``chip_smoke.py``'s prefix-heavy fleet
mix on 1, 2 and 4 replicas (sustained rps, TTFT, ITL, the router's call
times).  ``--cpu --fleet`` rehearses it with 4 CPU replicas at
llama_tiny's size.

``--elastic`` runs the scheduler tier across the four cards: a
``STRICT_PACK`` placement group of four ``{"GPU": 1}`` bundles gives four
tasks four distinct cards; then a placement group holds two of the four,
and ``TorchTrainer(min_workers=2, max_workers=4, resources_per_worker=
{"GPU": 1})`` trains the ``fit`` config over ``MeshConfig(fsdp=-1)`` with
an async save after every step.  It forms at 2; the group is removed after
step 2 once a save has committed, and the trainer upsizes to 4 at the next
checkpoint boundary and resumes from the latest commit.  ``world_size_history`` must be ``[2, 4]``, every step's
loss within ``TOL`` of one card's, and the flash kernels must launch in
every worker.  ``--cpu --elastic`` rehearses it over gloo with four
advertised cards (``init(num_tpus=4)``) at llama_tiny's size.

One JSON line a run; the last line is ``{"ok": true, "device": {...}}``.
Exits non-zero, printing no result, with fewer than two cards (two cards:
the dense fsdp2 and tp2 runs only).  ``--cpu`` runs the same code on 4 CPU
processes over gloo at llama_tiny's size, fp32, to rehearse it where there
is no card; it measures nothing.
"""

from __future__ import annotations

import json
import statistics
import sys
import tempfile
import time

import numpy as np

PEAK_BF16_FLOPS = 989e12
TRAIN_CFG = dict(vocab_size=32000, hidden=2048, layers=24, heads=16,
                 kv_heads=16, head_dim=128, mlp_dim=5632, max_seq_len=2048)
MOE_CFG = dict(vocab_size=32000, hidden=2048, layers=16, heads=16,
               kv_heads=8, head_dim=128, mlp_dim=5504, max_seq_len=2048,
               num_experts=8, moe_top_k=2, moe_capacity_factor=1.25)
# kind -> (card config, source, batch, seq; the CPU rehearsal's changes to
# llama_tiny, batch, seq).
CONFIGS = {
    "dense": (TRAIN_CFG, "bench.py:3384-3390", 8, 2048, {}, 8, 64),
    "long": (dict(TRAIN_CFG, max_seq_len=8192),
             "bench.py:3384-3390 at max_seq_len 8192", 2, 8192, {}, 2, 64),
    "moe": (MOE_CFG, "llama_1b widths, 8 experts, top-2, cf 1.25", 4, 2048,
            {"num_experts": 4}, 4, 64)}
STEPS, LR = 4, 1e-4
# Relative, against the one-card run (chip_smoke.py's TOL_TRAIN_BF16).
TOL = {"loss": 1e-3, "grad_norm": 5e-3}
# (name, config kind, mesh, config changes) by card count.
# The trainer run: steps, saves after these steps, rank 2's planted death
# after FIT_DIE_AT (once that save is committed), and the steps the reshape
# resume runs.
FIT_CFG = dict(TRAIN_CFG, layers=4)
FIT_BATCH, FIT_STEPS, FIT_SAVE_AT, FIT_DIE_AT = 4, 6, (1, 4), 3
FIT_RESHAPE_STEPS = 8
RUNS = {4: (("fsdp4", "dense", {"fsdp": 4}, {}),
            ("dp2xfsdp2", "dense", {"dp": 2, "fsdp": 2}, {}),
            ("dp2xtp2", "dense", {"dp": 2, "tp": 2}, {}),
            ("pp2xfsdp2", "dense", {"pp": 2, "fsdp": 2},
             {"pp_microbatches": 4}),
            ("ring_sp4", "long", {"sp": 4}, {"attention_impl": "ring"}),
            ("ulysses_sp4", "long", {"sp": 4},
             {"attention_impl": "ulysses"}),
            ("dp2xep2", "moe", {"dp": 2, "ep": 2}, {}),
            ("dp2xep2_free_routing", "moe", {"dp": 2, "ep": 2}, {})),
        2: (("fsdp2", "dense", {"fsdp": 2}, {}),
            ("tp2", "dense", {"tp": 2}, {}))}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _config(kind: str, changes, cpu: bool):
    """(config, param dtype, batch, seq) of a run."""
    import torch
    from ray_tpu_torch.models.llama import LlamaConfig, llama_tiny
    card, _src, batch, seq, tiny, cpu_batch, cpu_seq = CONFIGS[kind]
    if cpu:
        return (llama_tiny().replace(dtype=torch.float32, remat=True,
                                     **tiny, **changes),
                torch.float32, cpu_batch, cpu_seq)
    return (LlamaConfig(**card, dtype=torch.bfloat16, remat=True,
                        **dict(dict(attention_impl="flash"), **changes)),
            torch.bfloat16, batch, seq)


def _batches(cfg, batch, seq):
    rng = np.random.default_rng(0)
    return [{"tokens": rng.integers(0, cfg.vocab_size, (batch, seq),
                                    dtype=np.int32)} for _ in range(STEPS)]


def _train(mesh, kind: str, changes, cpu: bool, routing=None):
    """STEPS adamw steps on ``mesh``: (loss and grad norm a step, step
    seconds, peak bytes, param bytes, flash launches).  An MoE config on
    one card also records its expert choices (``routing`` in the result,
    on the CPU); ``routing`` given, a rank replays its tokens' share of
    that record (``chip_smoke.SameRouting``)."""
    import torch
    from chip_smoke import SameRouting
    from ray_tpu_torch.ops.attention import (flash_bwd_dkv, flash_bwd_dq,
                                             flash_fwd)
    from ray_tpu_torch.parallel import make_lm_train_step
    from ray_tpu_torch.train.mesh.runtime import per_device_param_bytes
    cfg, dtype, batch, seq = _config(kind, changes, cpu)
    init_fn, step_fn, place = make_lm_train_step(
        cfg, mesh, learning_rate=LR, param_dtype=dtype)
    params, opt = init_fn(torch.Generator(
        device="cpu" if cpu else "cuda").manual_seed(0))
    nbytes = list(per_device_param_bytes(params).values())[0]
    sync = (lambda: None) if cpu else torch.cuda.synchronize
    if not cpu:
        torch.cuda.reset_peak_memory_stats()
    for fn in (flash_fwd, flash_bwd_dq, flash_bwd_dkv):
        fn.launches = 0
    metrics, seconds = [], []

    def steps(params, opt):
        for b in _batches(cfg, batch, seq):
            sync()
            t0 = time.perf_counter()
            params, opt, m = step_fn(params, opt, place(b))
            sync()
            seconds.append(time.perf_counter() - t0)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))

    record = cfg.num_experts and mesh.device_mesh is None
    same = (SameRouting(routing, _local_tokens(mesh, batch, seq))
            if routing is not None else SameRouting())
    if record or routing is not None:
        same.run(lambda: steps(params, opt), record=routing is None)
    else:
        steps(params, opt)
    return {"metrics": metrics, "seconds": seconds,
            "routing": [c.cpu() for c in same.choices] if record else None,
            "peak_gb": 0.0 if cpu else torch.cuda.max_memory_allocated()
            / 2**30, "param_bytes": nbytes,
            "launches": {fn.__name__: fn.launches
                         for fn in (flash_fwd, flash_bwd_dq,
                                    flash_bwd_dkv)}}


def _local_tokens(mesh, batch: int, seq: int):
    """A whole-batch [B, S, k] array -> this rank's rows (split over dp,
    fsdp) and positions (split over sp)."""
    shape = mesh.shape
    rows = shape["dp"] * shape["fsdp"]
    row = mesh.coordinate("dp") * shape["fsdp"] + mesh.coordinate("fsdp")
    b, s = batch // rows, seq // shape["sp"]
    col = mesh.coordinate("sp")
    return lambda whole: whole[row * b:(row + 1) * b, col * s:(col + 1) * s]


def _rank(rank, world, kind, spec_kw, changes, cpu, routing):
    from ray_tpu_torch.parallel import MeshSpec, build_mesh
    return _train(build_mesh(MeshSpec(**spec_kw),
                             device="cpu" if cpu else None), kind, changes,
                  cpu, routing)


def _row(name, kind, runs, ref, cfg, batch, seq, smi):
    from chip_smoke import active_params
    first = runs[0]
    step_s = statistics.median(first["seconds"][1:])
    tok_s = batch * seq / step_s
    errs = {"loss": max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(
                first["metrics"], ref["metrics"])),
            "grad_norm": max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(
                first["metrics"], ref["metrics"]))}
    return {"run": name, "card": smi, "config": CONFIGS[kind][1],
            "attention_impl": cfg.attention_impl,
            "pp_microbatches": cfg.pp_microbatches,
            "batch": [batch, seq], "steps": STEPS, "step_ms": step_s * 1e3,
            "tokens_per_s": tok_s,
            "mfu_per_card": 6.0 * active_params(cfg) * tok_s
            / PEAK_BF16_FLOPS / len(runs),
            "losses": [m[0] for m in first["metrics"]],
            "grad_norms": [m[1] for m in first["metrics"]],
            "rel_err_vs_one_card": errs, "tol": TOL,
            "same_on_every_rank": all(r["metrics"] == first["metrics"]
                                      for r in runs),
            "param_bytes_by_rank": [r["param_bytes"] for r in runs],
            "peak_gb_by_rank": [r["peak_gb"] for r in runs],
            "launches_by_rank": [r["launches"] for r in runs]}


def _fit_cfg(cpu: bool):
    import torch
    from ray_tpu_torch.models.llama import LlamaConfig, llama_tiny
    if cpu:
        return (llama_tiny().replace(dtype=torch.float32, remat=True),
                torch.float32, 64)
    return (LlamaConfig(**FIT_CFG, dtype=torch.bfloat16, remat=True,
                        attention_impl="flash"), torch.bfloat16, 2048)


def _fit_batch(cfg, step: int, seq: int):
    rng = np.random.default_rng(100 + step)
    return {"tokens": rng.integers(0, cfg.vocab_size, (FIT_BATCH, seq),
                                   dtype=np.int32)}


def fit_train_fn(config):
    """The trainer run's train fn (module level: each worker imports it
    from this file)."""
    import os

    import torch
    import ray_tpu_torch.train as train
    from ray_tpu_torch._tree import tree_map
    from ray_tpu_torch.checkpoint.format import is_committed
    from ray_tpu_torch.models.llama import param_logical_axes
    from ray_tpu_torch.ops.attention import (flash_bwd_dkv, flash_bwd_dq,
                                             flash_fwd)
    from ray_tpu_torch.optim import AdamState
    from ray_tpu_torch.parallel import make_lm_train_step
    cpu = config["cpu"]
    if not cpu:
        torch.backends.cuda.matmul.allow_tf32 = False
    ctx = train.get_context()
    cfg, dtype, seq = _fit_cfg(cpu)
    mesh = train.get_mesh()
    init_fn, step_fn, place = make_lm_train_step(
        cfg, mesh, learning_rate=LR, param_dtype=dtype)
    axes = param_logical_axes(cfg)
    t0 = time.perf_counter()
    state = train.load_sharded({"params": axes, "mu": axes, "nu": axes,
                                "count": None, "step": None})
    if state is None:
        params, opt = init_fn(torch.Generator(
            device="cpu" if cpu else "cuda").manual_seed(0))
        start, restore_s = 0, None
    else:
        params = tree_map(lambda p: p.requires_grad_(True),
                          state["params"])
        opt = AdamState(state["count"], state["mu"], state["nu"])
        start, restore_s = int(state["step"]), time.perf_counter() - t0
    sync = (lambda: None) if cpu else torch.cuda.synchronize
    for step in range(start, config["last_step"]):
        sync()
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, place(_fit_batch(cfg, step,
                                                               seq)))
        loss = float(m["loss"])
        metrics = {"step": step, "loss": loss,
                   "step_ms": (time.perf_counter() - t0) * 1e3,
                   "wall": time.time(), "resumed_from": start,
                   "mesh": mesh.shape, "restore_s": restore_s,
                   "launches": {fn.__name__: fn.launches for fn in
                                (flash_fwd, flash_bwd_dq, flash_bwd_dkv)}}
        if step in FIT_SAVE_AT:
            t0 = time.perf_counter()
            path = train.save_checkpoint({
                "params": params, "mu": opt.mu, "nu": opt.nu,
                "count": opt.count, "step": step + 1})
            metrics["ckpt_block_s"] = time.perf_counter() - t0
        train.report(metrics)
        if step == FIT_DIE_AT and ctx.get_world_rank() == 2 and \
                not os.path.exists(config["marker"]):
            ctx.checkpoint_client().flush()
            while not is_committed(path):
                time.sleep(0.01)
            open(config["marker"], "w").close()
            train.report({"planted_death": time.time()})
            os._exit(1)


def _fit_runs(cpu: bool, smi):
    """The trainer run and its reshape resume, held to one card: the
    JSON line, and whether it held."""
    import torch
    from ray_tpu_torch.parallel import build_mesh, make_lm_train_step
    from ray_tpu_torch.train import (FailureConfig, MeshConfig, RunConfig,
                                     ScalingConfig, TorchTrainer)
    cfg, dtype, seq = _fit_cfg(cpu)
    init_fn, step_fn, place = make_lm_train_step(
        cfg, build_mesh(device="cpu" if cpu else "cuda"), learning_rate=LR,
        param_dtype=dtype)
    params, opt = init_fn(torch.Generator(
        device="cpu" if cpu else "cuda").manual_seed(0))
    bare = []
    for step in range(FIT_RESHAPE_STEPS):
        params, opt, m = step_fn(params, opt, place(_fit_batch(cfg, step,
                                                               seq)))
        bare.append(float(m["loss"]))
    del params, opt, m
    if not cpu:
        torch.cuda.empty_cache()
    out = {"run": "fit", "card": smi, "config": "bench.py:3384-3390 "
           "width, 4 layers" if not cpu else "llama_tiny",
           "batch": [FIT_BATCH, seq], "loss_one_card": bare, "tol": TOL}
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        for name, mesh, last in (("fsdp4", MeshConfig(fsdp=4), FIT_STEPS),
                                 ("dp2xfsdp2", MeshConfig(dp=2, fsdp=2),
                                  FIT_RESHAPE_STEPS)):
            t0 = time.perf_counter()
            result = TorchTrainer(
                fit_train_fn, train_loop_config={
                    "cpu": cpu, "last_step": last,
                    "marker": f"{tmp}/died"},
                scaling_config=ScalingConfig(
                    num_workers=4, mesh_config=mesh,
                    device="cpu" if cpu else None),
                run_config=RunConfig(name="fit", storage_path=tmp,
                                     failure_config=FailureConfig(
                                         max_failures=1))).fit()
            reps = [r for r in result.all_reports
                    if "step" in r["metrics"]]
            errs = [abs(r["metrics"]["loss"] - bare[r["metrics"]["step"]])
                    / abs(bare[r["metrics"]["step"]]) for r in reps]
            rank0 = [r["metrics"] for r in reps if r["rank"] == 0]
            death = [r["metrics"]["planted_death"]
                     for r in result.all_reports
                     if "planted_death" in r["metrics"]]
            resumed = [m for m in rank0 if m["resumed_from"] > 0]
            launches = {}
            for r in reps:
                launches.setdefault(r["rank"], {}).update(
                    r["metrics"]["launches"])
            problems = (result.checkpoint.validate(deep=True)
                        if result.checkpoint else ["no checkpoint"])
            out[name] = {
                "fit_s": time.perf_counter() - t0,
                "error": repr(result.error) if result.error else None,
                "num_failures": result.num_failures,
                "mesh": result.mesh,
                "formation_s": result.formation_seconds,
                "loss": [[m["step"], m["loss"]] for m in rank0],
                "max_rel_err_vs_one_card": max(errs) if errs else None,
                "step_ms": [m["step_ms"] for m in rank0],
                "ckpt_block_s": [m["ckpt_block_s"] for m in rank0
                                 if "ckpt_block_s" in m],
                "restore_s": [m["restore_s"] for m in resumed[:1]],
                "time_to_recover_s": resumed[0]["wall"] - death[0]
                if death and resumed else None,
                "goodput": result.goodput,
                "step_phases": result.step_phases,
                "checkpoint_problems": problems,
                "launches_by_rank": [launches.get(r, {})
                                     for r in range(4)]}
            launched = cpu or all(v > 0 for r in range(4)
                                  for v in launches.get(r, {}).values())
            want = ({"failures": 1, "resumed": FIT_SAVE_AT[0] + 1}
                    if name == "fsdp4" else
                    {"failures": 0, "resumed": FIT_SAVE_AT[-1] + 1})
            ok = ok and result.error is None and not problems and \
                launched and result.num_failures == want["failures"] and \
                bool(errs) and max(errs) <= TOL["loss"] and \
                bool(resumed) and \
                resumed[0]["step"] == want["resumed"]
    out["held"] = ok
    return out, ok


ELASTIC_STEPS = 8


def card_probe(cpu: bool):
    """A one-card task: the card it was pinned to, and how many it sees
    (module level: the task worker imports it)."""
    import os
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if cpu:
        return visible, 1
    import torch
    return visible, torch.cuda.device_count()


def elastic_train_fn(config):
    """The elastic run's train fn: the ``fit`` config over the group's
    fsdp mesh, an async save after every step, resumed from the latest
    (module level: each worker imports it)."""
    import torch
    import ray_tpu_torch.train as train
    from ray_tpu_torch._tree import tree_map
    from ray_tpu_torch.models.llama import param_logical_axes
    from ray_tpu_torch.ops.attention import (flash_bwd_dkv, flash_bwd_dq,
                                             flash_fwd)
    from ray_tpu_torch.optim import AdamState
    from ray_tpu_torch.parallel import make_lm_train_step
    cpu = config["cpu"]
    if not cpu:
        torch.backends.cuda.matmul.allow_tf32 = False
    ctx = train.get_context()
    cfg, dtype, seq = _fit_cfg(cpu)
    mesh = train.get_mesh()
    init_fn, step_fn, place = make_lm_train_step(
        cfg, mesh, learning_rate=LR, param_dtype=dtype)
    axes = param_logical_axes(cfg)
    state = train.load_sharded({"params": axes, "mu": axes, "nu": axes,
                                "count": None, "step": None})
    if state is None:
        params, opt = init_fn(torch.Generator(
            device="cpu" if cpu else "cuda").manual_seed(0))
        start = 0
    else:
        params = tree_map(lambda p: p.requires_grad_(True),
                          state["params"])
        opt = AdamState(state["count"], state["mu"], state["nu"])
        start = int(state["step"])
    sync = (lambda: None) if cpu else torch.cuda.synchronize
    for step in range(start, ELASTIC_STEPS):
        sync()
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, place(_fit_batch(cfg, step,
                                                               seq)))
        loss = float(m["loss"])
        step_ms = (time.perf_counter() - t0) * 1e3
        # The CPU rehearsal's steps are paced to the card's (a step and
        # its save take seconds there), so the resize lands mid-run.
        time.sleep(max(0.0, config["pace_s"] - step_ms / 1e3))
        train.save_checkpoint({"params": params, "mu": opt.mu, "nu": opt.nu,
                               "count": opt.count, "step": step + 1})
        train.report({"step": step, "loss": loss, "step_ms": step_ms,
                      "world": ctx.get_world_size(), "resumed_from": start,
                      "mesh": mesh.shape,
                      "launches": {fn.__name__: fn.launches for fn in
                                   (flash_fwd, flash_bwd_dq,
                                    flash_bwd_dkv)}})


def _elastic_run(cpu: bool, smi):
    """Four tasks on four cards through a ``STRICT_PACK`` group, then the
    elastic trainer upsizing from 2 to 4 cards when a placement group
    holding two is removed: the JSON line, and whether it held."""
    import threading

    import torch

    import ray_tpu_torch as rtt
    from ray_tpu_torch.parallel import build_mesh, make_lm_train_step
    from ray_tpu_torch.train import (CheckpointConfig, FailureConfig,
                                     MeshConfig, RunConfig, ScalingConfig,
                                     TorchTrainer)
    from ray_tpu_torch.train.controller import TrainController
    cfg, dtype, seq = _fit_cfg(cpu)
    init_fn, step_fn, place = make_lm_train_step(
        cfg, build_mesh(device="cpu" if cpu else "cuda"), learning_rate=LR,
        param_dtype=dtype)
    params, opt = init_fn(torch.Generator(
        device="cpu" if cpu else "cuda").manual_seed(0))
    bare = []
    for step in range(ELASTIC_STEPS):
        params, opt, m = step_fn(params, opt, place(_fit_batch(cfg, step,
                                                               seq)))
        bare.append(float(m["loss"]))
    del params, opt, m
    if not cpu:
        torch.cuda.empty_cache()
    out = {"run": "elastic", "card": smi,
           "config": "llama_tiny" if cpu else
           "bench.py:3384-3390 width, 4 layers",
           "batch": [FIT_BATCH, seq], "loss_one_card": bare, "tol": TOL}
    session = rtt.init(num_cpus=8, num_tpus=4 if cpu else None)
    try:
        out["cluster_resources"] = {k: v for k, v in
                                    rtt.cluster_resources().items()
                                    if k != "memory"}
        pg = rtt.placement_group([{"GPU": 1}] * 4, strategy="STRICT_PACK")
        packed = pg.ready(timeout=60)
        probes = rtt.get([rtt.remote(
            num_cpus=0, num_tpus=1, placement_group=pg,
            placement_group_bundle_index=i)(card_probe).remote(cpu)
            for i in range(4)], timeout=600)
        rtt.remove_placement_group(pg)
        out["strict_pack"] = {"ready": packed, "tasks": probes}
        hold = rtt.placement_group([{"GPU": 1}, {"GPU": 1}])
        held = hold.ready(timeout=60)
        with tempfile.TemporaryDirectory() as tmp:
            trainer = TorchTrainer(
                elastic_train_fn, train_loop_config={
                    "cpu": cpu, "pace_s": 0.5 if cpu else 0.0},
                scaling_config=ScalingConfig(
                    min_workers=2, max_workers=4,
                    resources_per_worker={"GPU": 1},
                    mesh_config=MeshConfig(fsdp=-1),
                    elastic_check_interval_s=0.5,
                    device="cpu" if cpu else None),
                run_config=RunConfig(name="elastic", storage_path=tmp,
                                     failure_config=FailureConfig(
                                         max_failures=1),
                                     checkpoint_config=CheckpointConfig(
                                         num_to_keep=2)))
            controller = TrainController(trainer._train_fn, trainer._config,
                                         trainer._scaling,
                                         trainer._run_config)
            box = {}
            t0 = time.perf_counter()
            if not cpu:
                from ray_tpu_torch.ops import _build
                _build.build()
            t = threading.Thread(target=lambda: box.update(
                r=controller.run()), daemon=True)
            t.start()
            removed_at = None
            deadline = time.monotonic() + 900
            while t.is_alive() and time.monotonic() < deadline:
                # After step 2, once a save has committed: with none, the
                # elastic loop re-forms at once and replays from step 0
                # (JAX's rule), and the run would show no resume.
                if removed_at is None and any(
                        r["rank"] == 0 and r["metrics"].get("step", -1) >= 2
                        for r in list(controller._reports)) and \
                        controller.manager.latest() is not None:
                    rtt.remove_placement_group(hold)
                    removed_at = time.time()
                t.join(timeout=0.1)
            result = box.get("r")
        fit_s = time.perf_counter() - t0
        avail = rtt.available_resources()
    finally:
        rtt.shutdown()
    if result is None:
        out.update(error="the elastic fit did not finish", held=False)
        return out, False
    reps = [r for r in result.all_reports if "step" in r["metrics"]]
    rank0 = [r["metrics"] for r in reps if r["rank"] == 0]
    errs = [abs(r["metrics"]["loss"] - bare[r["metrics"]["step"]])
            / abs(bare[r["metrics"]["step"]]) for r in reps]
    launches = {}
    for r in reps:
        launches.setdefault((r["metrics"]["world"], r["rank"]), {}).update(
            r["metrics"]["launches"])
    resumed = [m for m in rank0 if m["world"] == 4]
    visible = [p[0] for p in probes]
    out.update({
        "fit_s": fit_s, "error": repr(result.error) if result.error else None,
        "held_pg_ready": held, "world_size_history":
        result.world_size_history, "formation_s": result.formation_seconds,
        "pg_removed_after_step": 2,
        "resumed_from": resumed[0]["resumed_from"] if resumed else None,
        "loss": [[m["world"], m["step"], m["loss"]] for m in rank0],
        "step_ms": [[m["world"], m["step_ms"]] for m in rank0],
        "max_rel_err_vs_one_card": max(errs) if errs else None,
        "goodput": result.goodput,
        "launches_by_world_rank": {f"w{w}r{r}": v for (w, r), v in
                                   sorted(launches.items())},
        "available_after": {k: v for k, v in avail.items()
                            if k != "memory"}})
    launched = cpu or (len(launches) == 6 and all(
        v > 0 for d in launches.values() for v in d.values()))
    ok = (packed and held and len(set(visible)) == 4
          and all(p[1] == 1 for p in probes)
          and result.error is None
          and result.world_size_history == [2, 4]
          and bool(errs) and max(errs) <= TOL["loss"]
          and bool(resumed) and resumed[0]["resumed_from"] >= 1
          and launched and avail.get("GPU") == 4.0)
    out["held"] = ok
    return out, ok


def _collective_run(cpu: bool, smi):
    """``--collective``: the group over every card (NCCL), or over 4 CPU
    actors (gloo); its results held to numpy (``chip_smoke``'s member and
    check)."""
    import torch
    from chip_smoke import CollectiveMember, check_collective
    from ray_tpu_torch import _actor
    world = 4 if cpu else torch.cuda.device_count()
    t0 = time.perf_counter()
    members = [_actor.remote(CollectiveMember).options(
        device="cpu" if cpu else f"cuda:{r}", num_cpus=1).remote(r, world)
        for r in range(world)]
    try:
        results = _actor.get([m.run.remote("sharded", "gloo" if cpu
                                           else "nccl") for m in members],
                             timeout=600)
    finally:
        _actor.shutdown()
    ok = check_collective(results, world)
    return {"run": "collective", "backend": "gloo" if cpu else "nccl",
            "world": world, "correct": ok, "card": smi,
            "allreduce_4mib_ms": [r["allreduce_4mib_ms"] for r in results],
            "seconds": time.perf_counter() - t0}, ok


def _fleet_card_env(k: int, world: int):
    """The environment of card ``k``'s replica: its card first (its
    ``"cuda"``), every other card visible after it (to open peers'
    IPC handles)."""
    import os
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    cards = visible.split(",") if visible else [str(i) for i in range(world)]
    order = [cards[k]] + [c for i, c in enumerate(cards) if i != k]
    return {"CUDA_VISIBLE_DEVICES": ",".join(order)}


def _fleet_run(cpu: bool, smi):
    """``--fleet``: see the module docstring."""
    import threading

    import torch

    import chip_smoke as cs
    from ray_tpu_torch.llm import SamplingParams
    from ray_tpu_torch.llm.disagg import (PrefillWorker, ServeLoadSpec,
                                          run_open_loop)
    from ray_tpu_torch.llm.fleet import (FleetConfig, FleetServer,
                                         RemoteReplica)
    device = "cpu" if cpu else "cuda"
    world = 4 if cpu else torch.cuda.device_count()
    if cpu:      # the rehearsal's sizes (llama_tiny's 256 positions)
        cs.SERVE_OPTS = dict(max_slots=4, page_size=16,
                             prefill_buckets=(64, 128), num_pages=96)
        cs.FLEET_PROMPT, cs.FLEET_POOL = 100, 4
        cs.FLEET_RPS, cs.FLEET_DURATION_S = 10.0, 1.0
        cs.REMOTE_EXACT = ((100, 4), (50, 4), (20, 4), (100, 4))
    build = cs._replica_build(device, "llama_tiny" if cpu else "llama_1b")
    eo = dict(cs.SERVE_OPTS, device=device)
    params, cfg = build()
    t0 = time.perf_counter()

    def replica(name, k, on_finish, cache_bytes=1 << 20):
        env = {"OMP_NUM_THREADS": "1"} if cpu else _fleet_card_env(k, world)
        return RemoteReplica(build, name=name, engine_options=eo,
                             cache_capacity_bytes=cache_bytes,
                             record_token_times=True, on_finish=on_finish,
                             actor_options={"env_vars": env})

    # Exactness: every card's replica imports the same handoffs alone.
    done = {}

    def on_finish(rep, req):
        done[(rep.name, req.request_id)] = list(req.output_tokens)

    reps = [None] * world

    def start(k):
        reps[k] = replica(f"card{k}", k, on_finish)
    threads = [threading.Thread(target=start, args=(k,))
               for k in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    start_s = time.perf_counter() - t0
    pw = PrefillWorker(params, cfg, device=device,
                       prefill_buckets=eo["prefill_buckets"],
                       page_size=eo["page_size"])
    rng = np.random.default_rng(41)
    by_card = [[] for _ in range(world)]
    try:
        for n, new in cs.REMOTE_EXACT:
            prompt = rng.integers(1, cfg.vocab_size, n).tolist()
            h = pw.prefill(prompt, SamplingParams(max_tokens=new))
            rids = [rep.import_prefill(h) for rep in reps]
            deadline = time.perf_counter() + 300
            while not all((rep.name, rid) in done
                          for rep, rid in zip(reps, rids)):
                assert time.perf_counter() < deadline, "exactness stalled"
                time.sleep(0.01)
            for k, (rep, rid) in enumerate(zip(reps, rids)):
                by_card[k].append(done[(rep.name, rid)])
    finally:
        for rep in reps:
            rep.kill()
    equal = all(toks == by_card[0] for toks in by_card[1:])
    out = {"run": "fleet", "card": smi, "world": world,
           "model": "llama_tiny" if cpu else "llama_1b",
           "replica_start_s": start_s,
           "exact": {"requests": len(cs.REMOTE_EXACT),
                     "tokens_equal_to_card0": equal}}
    entry = pw.prefill(list(range(1, cs.FLEET_PROMPT + 1)),
                       SamplingParams(max_tokens=cs.FLEET_MAX_TOKENS)).nbytes
    cache_bytes = int(entry * (cs.FLEET_POOL // 2) + entry // 2)
    spec = dict(rps=cs.FLEET_RPS, duration_s=cs.FLEET_DURATION_S,
                long_fraction=1.0, long_prompt=cs.FLEET_PROMPT,
                long_max_tokens=cs.FLEET_MAX_TOKENS, short_prompt=32,
                short_max_tokens=cs.FLEET_MAX_TOKENS,
                prompt_pool=cs.FLEET_POOL, drain_timeout_s=120.0)
    ok = equal
    for n in sorted({1, 2, world}):
        def factory(name, on_fin, _n=n):
            k = int(name.rsplit("-r", 1)[1]) % world
            return replica(name, k, on_fin, cache_bytes)
        t1 = time.perf_counter()
        srv = FleetServer(lambda: (params, cfg), name=f"cards{n}",
                          admission=cs._open_admission(),
                          config=FleetConfig(num_replicas=n,
                                             engine_options=eo,
                                             cache_capacity_bytes=cache_bytes),
                          record_token_times=True, replica_factory=factory)
        fleet_start_s = time.perf_counter() - t1
        try:
            pubs = [srv.submit({"prompt_tokens": [1] * (cs.FLEET_PROMPT - i),
                                "max_tokens": 2, "timeout_s": 300})
                    for i in range(2 * n)]
            for x in pubs:
                srv.result(x, timeout_s=300)
            waits = cs._time_remote_calls(srv)
            r = run_open_loop(srv, ServeLoadSpec(**spec), cfg.vocab_size)
            st = srv.status()
        finally:
            srv.close()
        row = cs._load_row(r)
        row.update(replicas=n, start_s=fleet_start_s, prefix=st["prefix"],
                   router_calls=cs._summarize_waits(waits))
        out[f"replicas_{n}"] = row
        ok = ok and r["unfinished"] == 0 and r["errors"] == 0
    out["sustained_rps"] = {n: out[f"replicas_{n}"]["sustained_rps"]
                            for n in sorted({1, 2, world})}
    out["seconds"] = time.perf_counter() - t0
    return out, ok


def main(argv) -> int:
    cpu = "--cpu" in argv
    fit_only = "--fit" in argv
    collective_only = "--collective" in argv
    fleet_only = "--fleet" in argv
    elastic_only = "--elastic" in argv
    import torch
    from ray_tpu_torch._device import card_power_line
    from ray_tpu_torch.parallel import build_mesh
    from ray_tpu_torch.parallel.launch import run_local
    world = 4 if cpu else torch.cuda.device_count()
    if (fit_only or elastic_only) and world < 4:
        print("sharded_smoke: the trainer runs need four cards",
              file=sys.stderr)
        return 1
    if not cpu and world < 2:
        print("sharded_smoke: needs two or more CUDA cards", file=sys.stderr)
        return 1
    smi = None
    if not cpu:
        from ray_tpu_torch.ops import _build
        torch.backends.cuda.matmul.allow_tf32 = False
        smi = card_power_line(0)
        print(smi, flush=True)
        if not collective_only:    # the collective group runs no kernel
            t0 = time.perf_counter()
            _build.build()
            emit({"phase": "build", "seconds": time.perf_counter() - t0})
    refs = {}
    failed = []
    if collective_only:
        row, ok = _collective_run(cpu, smi)
        emit(row)
        if not ok:
            failed.append("collective")
    if fleet_only:
        row, ok = _fleet_run(cpu, smi)
        emit(row)
        if not ok:
            failed.append("fleet")
    if elastic_only:
        row, ok = _elastic_run(cpu, smi)
        emit(row)
        if not ok:
            failed.append("elastic")
    only = fit_only or collective_only or fleet_only or elastic_only
    runs = () if only else RUNS[4 if world >= 4 else 2]
    for name, kind, spec_kw, changes in runs:
        if kind not in refs:
            if not cpu:
                refs.clear()
                torch.cuda.empty_cache()
            refs[kind] = _train(build_mesh(device="cpu" if cpu else "cuda"),
                                kind, {}, cpu)
            cfg, _d, batch, seq = _config(kind, {}, cpu)
            emit(_row(f"one_card_{kind}", kind, [refs[kind]], refs[kind],
                      cfg, batch, seq, smi))
            if not cpu:
                torch.cuda.empty_cache()
        cfg, _d, batch, seq = _config(kind, changes, cpu)
        n = int(np.prod(list(spec_kw.values())))
        # An MoE run replays the one-card run's expert choices, so the
        # two make the same discrete top-k choices and drops; the free
        # run's near-tied choices flip with the split's other rounding
        # and move the gradients by whole MLP outputs: it is reported,
        # its loss held to TOL.
        free = name.endswith("_free_routing")
        routing = None if free else refs[kind]["routing"]
        with tempfile.TemporaryDirectory() as rdv:
            runs = run_local(_rank, n, rdv, kind, spec_kw, changes, cpu,
                             routing, backend="gloo" if cpu else "nccl",
                             timeout=900)
        row = _row(name, kind, runs, refs[kind], cfg, batch, seq, smi)
        row["same_routing_as_one_card"] = routing is not None
        held = ("loss",) if free else tuple(TOL)
        row["held_to_tol"] = held
        emit(row)
        errs = row["rel_err_vs_one_card"]
        launched = cpu or all(v > 0 for r in row["launches_by_rank"]
                              for v in r.values())
        if not (row["same_on_every_rank"] and launched
                and all(errs[k] <= TOL[k] for k in held)):
            failed.append(name)
    if world >= 4 and not (collective_only or fleet_only or elastic_only):
        if not cpu:
            refs.clear()
            torch.cuda.empty_cache()
        row, ok = _fit_runs(cpu, smi)
        emit(row)
        if not ok:
            failed.append("fit")
    if failed:
        print(f"sharded_smoke: meshes disagree with one card: {failed}",
              file=sys.stderr)
        return 1
    if not cpu:
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
