#!/usr/bin/env python3
"""The port's sharded training step on the NVIDIA cards of one host.

    python3 sharded_smoke.py           # every visible card, 2 or more
    python3 sharded_smoke.py --cpu     # rehearsal: 4 gloo ranks on the CPU

Run from the root of a checkout on a machine with two or more CUDA cards
and nvcc.  It builds the kernels, trains the 1.36B config of
``bench.py:3384-3390`` (bf16 params and adam state, full remat, flash
attention; batch 8 x 2048) for 4 adamw steps with ``make_lm_train_step`` on
one card, then the same 4 steps from the same init and batches sharded over
every card through ``torch.distributed`` (NCCL, one process a card) on the
meshes of ``MESHES`` (for 4 cards: fsdp4, dp2 x fsdp2, dp2 x tp2).  Each
mesh's losses and grad norms are held to the one-card run's
(``TOL_TRAIN_BF16``: bf16 sums in another order and another split).  It
reports each run's step ms (the median of steps 2-4, host clock around a
synchronize), tokens/s, every rank's param bytes and peak memory, and the
flash kernels' launches on each rank (the kernels run on each rank's batch
rows and heads).  One JSON line a run; the last line is ``{"ok": true,
"device": {...}}``.  Exits non-zero, printing no result, with fewer than
two cards.  ``--cpu`` runs the same code on 4 CPU processes over gloo at
llama_tiny's size, fp32, to rehearse it where there is no card; it
measures nothing.
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
BATCH, SEQ, STEPS, LR = 8, 2048, 4, 1e-4
# Relative, against the one-card run (chip_smoke.py's TOL_TRAIN_BF16).
TOL = {"loss": 1e-3, "grad_norm": 5e-3}
MESHES = {4: ({"fsdp": 4}, {"dp": 2, "fsdp": 2}, {"dp": 2, "tp": 2}),
          2: ({"fsdp": 2}, {"tp": 2})}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _config(cpu: bool):
    import torch
    from ray_tpu_torch.models.llama import LlamaConfig, llama_tiny
    if cpu:
        return llama_tiny().replace(dtype=torch.float32, remat=True), \
            torch.float32, 8, 64
    return (LlamaConfig(**TRAIN_CFG, dtype=torch.bfloat16, remat=True,
                        attention_impl="flash"), torch.bfloat16, BATCH, SEQ)


def _batches(cfg, batch, seq):
    rng = np.random.default_rng(0)
    return [{"tokens": rng.integers(0, cfg.vocab_size, (batch, seq),
                                    dtype=np.int32)} for _ in range(STEPS)]


def _train(mesh, cpu: bool):
    """STEPS adamw steps on ``mesh``: (loss and grad norm a step, step
    seconds, peak bytes, param bytes, flash launches)."""
    import torch
    from ray_tpu_torch.ops.attention import (flash_bwd_dkv, flash_bwd_dq,
                                             flash_fwd)
    from ray_tpu_torch.parallel import make_lm_train_step
    from ray_tpu_torch.train.mesh.runtime import per_device_param_bytes
    cfg, dtype, batch, seq = _config(cpu)
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
    for b in _batches(cfg, batch, seq):
        sync()
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, place(b))
        sync()
        seconds.append(time.perf_counter() - t0)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return {"metrics": metrics, "seconds": seconds,
            "peak_gb": 0.0 if cpu else torch.cuda.max_memory_allocated()
            / 2**30, "param_bytes": nbytes,
            "launches": {fn.__name__: fn.launches
                         for fn in (flash_fwd, flash_bwd_dq,
                                    flash_bwd_dkv)}}


def _rank(rank, world, spec_kw, cpu):
    from ray_tpu_torch.parallel import MeshSpec, build_mesh
    return _train(build_mesh(MeshSpec(**spec_kw),
                             device="cpu" if cpu else None), cpu)


def _row(name, runs, ref, cfg, batch, seq, smi):
    from ray_tpu_torch.models.llama import num_params
    first = runs[0]
    step_s = statistics.median(first["seconds"][1:])
    tok_s = batch * seq / step_s
    errs = {"loss": max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(
                first["metrics"], ref["metrics"])),
            "grad_norm": max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(
                first["metrics"], ref["metrics"]))}
    return {"run": name, "card": smi, "config": "bench.py:3384-3390",
            "batch": [batch, seq], "steps": STEPS, "step_ms": step_s * 1e3,
            "tokens_per_s": tok_s,
            "mfu_per_card": 6.0 * num_params(cfg) * tok_s / PEAK_BF16_FLOPS
            / len(runs),
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
    cfg, _dtype, batch, seq = _config(cpu)
    ref = _train(build_mesh(device="cpu" if cpu else "cuda"), cpu)
    emit(dict(_row("one_card", [ref], ref, cfg, batch, seq, smi)))
    if not cpu:
        torch.cuda.empty_cache()
    failed = []
    for spec_kw in MESHES[4 if world >= 4 else 2]:
        n = int(np.prod(list(spec_kw.values())))
        name = "x".join(f"{a}{s}" for a, s in spec_kw.items())
        with tempfile.TemporaryDirectory() as rdv:
            runs = run_local(_rank, n, rdv, spec_kw, cpu,
                             backend="gloo" if cpu else "nccl",
                             timeout=900)
        row = _row(name, runs, ref, cfg, batch, seq, smi)
        emit(row)
        errs = row["rel_err_vs_one_card"]
        launched = cpu or all(v > 0 for r in row["launches_by_rank"]
                              for v in r.values())
        if not (row["same_on_every_rank"] and launched
                and all(errs[k] <= TOL[k] for k in TOL)):
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
