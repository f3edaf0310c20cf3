#!/usr/bin/env python3
"""The port's sharded training step on the NVIDIA cards of one host.

    python3 sharded_smoke.py           # every visible card, 2 or more
    python3 sharded_smoke.py --cpu     # rehearsal: 4 gloo ranks on the CPU

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
flash kernels' launches on each rank.  One JSON line a run; the last line
is ``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
with fewer than two cards (two cards: the dense fsdp2 and tp2 runs only).
``--cpu`` runs the same code on 4 CPU processes over gloo at llama_tiny's
size, fp32, to rehearse it where there is no card; it measures nothing.
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


def main(argv) -> int:
    cpu = "--cpu" in argv
    import torch
    from ray_tpu_torch._device import card_power_line
    from ray_tpu_torch.parallel import build_mesh
    from ray_tpu_torch.parallel.launch import run_local
    world = 4 if cpu else torch.cuda.device_count()
    if not cpu and world < 2:
        print("sharded_smoke: needs two or more CUDA cards", file=sys.stderr)
        return 1
    smi = None
    if not cpu:
        from ray_tpu_torch.ops import _build
        torch.backends.cuda.matmul.allow_tf32 = False
        smi = card_power_line(0)
        print(smi, flush=True)
        t0 = time.perf_counter()
        _build.build()
        emit({"phase": "build", "seconds": time.perf_counter() - t0})
    refs = {}
    failed = []
    for name, kind, spec_kw, changes in RUNS[4 if world >= 4 else 2]:
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
