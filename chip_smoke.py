#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and nvcc.  It
builds the port's kernels from ``ray_tpu_torch/csrc``, holds each against its
plain PyTorch version on the card (head_dim 32, 64 and 128), times them,
checks exact greedy serving on a narrow fp32 model, then serves
``llama_1b`` at full width and depth (random weights from a seeded
generator) through the port's entry points, greedy and sampled; serves the
JAX preset ``llama_tiny`` (head_dim 32); decodes on two streams and beside a
replayed CUDA graph.  It holds ``DisaggServer`` (each mode) and
``FleetServer`` to the per-token gold on a narrow fp32 model, then serves
``llama_1b`` behind each under open-loop Poisson traffic, at saturation,
through a replica killed in flight and an autoscale up and down
(``disagg_exact``, ``disagg_load``, ``fleet``).  It then checks exact fp32
training on a narrow model
and one step of ``llama_tiny``, trains the JAX bench's 1.36B-parameter
config (``bench.py:3384-3390``) at full width and depth through
``make_lm_train_step`` under full remat and under ``"dots"`` and
``"dots_nobatch"``, resumes a 4-layer model of its width from a
checkpoint, and trains that model through ``TorchTrainer.fit`` in a
spawned worker, through a planted failure and its restart (``trainer``).
Last, reinforcement learning (``ray_tpu_torch.rl``, which runs no kernel
of its own): each algorithm's update on the card against the same update
on the CPU, the CNN and GRU policies and the device-resident CartPole
(``rl_exact``); PPO at the default config through ``build().train()``
with its host syncs counted, a 4,096 x 128 device rollout and one
``train()`` of every other algorithm (``rl_train``); a BC update from a
``Dataset`` against the same from ``.npz`` (in ``rl_exact``).  The 1.36B
step fed from a ``Dataset`` (``data_train``, after ``train_dots``): a
seeded token corpus in raw int32 shards through read tasks, rows, the
two-stage shuffle over ``ray_tpu_torch.init``'s task workers,
``iter_batches`` and ``device_put_iterator``, against the same batches
placed from memory (bit-equal losses).  The process tier:
``build_llm_deployment`` at ``llama_1b`` in a replica process, its greedy
tokens against the in-process ``LLMServer`` and its kernels' launches
counted inside the replica (``serve_deployment``); a 960-token llama_1b
handoff exported here and opened in a replica process through CUDA IPC,
its K/V sums equal, a planted change after the export seen there, its
tokens equal an in-process import's (``handoff_ipc``); ``FleetServer``
with ``RemoteReplica`` processes, its streams against the in-process
fleet's, the prefix-heavy mix on 1 and 2 of them and a replica process
killed (``fleet_remote``); the llama_1b deployment under an
``AutoscalingConfig`` scaled up by a burst and back down, a killed replica
replaced, and the HTTP ingress against the handle (``serve_controller``);
PPO with 2 remote env runners and 2 DDP learners, then IMPALA at its
default config (``rl_remote``); a 2-process gloo collective group against
numpy (``collective``).  The developer tools: ``profiler.profile`` with a
``torch.profiler`` window while the deployment's replica serves, the
replica's kernels named in the merged trace (``profile``, inside
``serve_deployment``); prefill and decode as a compiled DAG over two
actor processes at llama_1b, its tokens against the in-process server's,
beside the same graph interpreted, and an allreduce node over two more
actors against numpy (``dag_disagg``); the host-sync tripwire over
``serve``'s mix and a PPO iteration, with a planted per-token ``.item()``
(``sync_tripwire``); kernel first launches per tracked site and a
recompile at a new batch size (``recompile``).  The scheduler tier: the
card booked as ``GPU`` by tasks with ``num_tpus=1`` (one after the other,
each pinned to the card and launching the flash forward at the serving
shape against its plain version), a placement group holding the card
while a task outside it waits, an infeasible ask, a nested task
(``sched_cards``); ``Tuner.fit`` over the 4-layer 1.36B step on the card,
4 trials under ASHA, two at a time, the lowest learning rate's losses
against the same steps bare here, bit for bit (``tune``).
The kernels' launch counts, set to 0 just before each path and
read just after, show that every path ran through them.  Each phase prints one JSON line; any failed
check raises and the script exits non-zero.  The last line is
``{"ok": true, "device": {...}}``.

Without a card (or outside a checkout) it exits non-zero and prints no
result.  It imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import gc
import json
import math
import os
import re
import sys
import threading
import time
import traceback
import warnings

import numpy as np

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

FLASH_SOURCE = "ray_tpu_torch/csrc/flash_fwd.cu"
FLASH_REPLACES = "ray_tpu/ops/attention.py:98"         # _fwd_kernel
PAGED_SOURCE = "ray_tpu_torch/csrc/paged_decode.cu"
PAGED_REPLACES = "ray_tpu/ops/paged_attention.py:65"   # _ragged_path
BWD_SOURCE = "ray_tpu_torch/csrc/flash_bwd.cu"
DQ_REPLACES = "ray_tpu/ops/attention.py:238"           # _dq_kernel
DKV_REPLACES = "ray_tpu/ops/attention.py:278"          # _dkv_kernel
# Stated tolerances (max abs error against the plain version, same inputs):
# fp32 sums in another order and exp2 vs exp; bf16 rounds P and O to bf16
# (one ulp of bf16 at |x| ~ 2 is 2**-6).
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# flash_fwd's second measure, the worst row's ||out - ref|| / ||ref|| over
# D (row_rel_err).  A long row's output is small (about sqrt(e / keys) per
# element at randn inputs: 0.04 at 2048 keys), so the absolute limit alone
# lets an error of tens of percent there pass.  Each of PLANTED_FWD_FAULTS
# must exceed the limit (tests/test_torch_build.py shows that the 5% one
# passes the absolute limit alone).  On an H100 the clean bf16 readings
# are 4.1e-3 to 5.6e-3 and the milder fault reads 5.3e-2; 2e-2 sits 3.6x
# above the one and 2.6x below the other.
TOL_ROW_REL = {"float32": 1e-4, "bfloat16": 2e-2}
# Faults planted in the forward's output on the long rows only (the last
# 128-row query tile), as a wrong ring stage or tile index there would
# make them: key tile 1 skipped, or the rows 5% too large.
PLANTED_FWD_FAULTS = ("skip_key_tile_1", "rows_x1.05")
# paged_decode's second measure, the worst live row's ||out - ref|| /
# ||ref|| over D (row_rel_err).  A row averages V over hundreds to
# thousands of tokens, so its elements are small (about sqrt(1 / len) at
# randn inputs) and the absolute limit alone would let a lost split or page
# pass.  Each of PLANTED_PAGED_FAULTS must exceed it
# (tests/test_torch_build.py shows it on the CPU); bf16 rounds the output
# once (2**-9 relative).
TOL_PAGED_ROW_REL = {"float32": 1e-4, "bfloat16": 2e-2}
# Faults planted in one live slot's output, as a wrong arrival count or
# range end would make them: the last split's partial left out of the
# merge, or the slot's last page skipped.
PLANTED_PAGED_FAULTS = ("split_partial_dropped", "last_page_skipped")
# llama_1b logits, kernel path vs plain path, teacher-forced: bf16 attention
# outputs differ by rounding and the difference compounds over 16 layers;
# the logits themselves have a std of about 1.
TOL_1B_LOGITS = 0.1
# flash_bwd vs its plain version: max abs error over the gradient's largest
# magnitude (dK and dV sum over every query, so their scale grows with S).
# fp32 sums in another order; bf16 rounds P, dS and the outputs to bf16
# (2**-8 relative each).
TOL_BWD = {"float32": 1e-4, "bfloat16": 2e-2}
# flash_bwd's second measure, the worst row's ||got - ref|| / ||ref|| over D
# (row_rel_err): per query row for dq, per key row for dk and dv.  Under
# causal attention the last keys' dK and dV rows sum over few queries and
# are small, so the limit above, relative to the largest magnitude, lets a
# wrong last key tile or ragged edge pass.  Each of PLANTED_BWD_FAULTS must
# exceed the limit (tests/test_torch_build.py shows that the 5% ones pass
# TOL_BWD alone).  bf16 rounds P and dS to bf16 (2**-9 relative each) and
# the outputs once more; a row of few terms keeps that whole.  On an H100
# the clean readings are at most 5.7e-3 over the bf16 cases (fp32: 3.0e-6)
# and the milder faults read 0.051: 2e-2 sits 3.5x above the one and 2.5x
# below the other.
TOL_BWD_ROW_REL = {"float32": 1e-4, "bfloat16": 2e-2}
# ... with a row's ||ref|| taken as at least this share of the largest
# row's: a query that sees one key has dQ = 0 (dP = delta there), and the
# residue of two summation orders would read as a 100% error.
BWD_ROW_FLOOR = 1e-3
# Faults planted in the backward's output on the edge tiles, as a wrong
# ring phase or tile index there would make them: the last 128-key tile of
# dK and dV left out (zeros) or 5% too large, the last 128-row query tile of
# dQ 5% too large.
PLANTED_BWD_FAULTS = ("dkv_last_key_tile_skipped", "dkv_last_key_tile_x1.05",
                      "dq_last_query_tile_x1.05")
# train_exact (fp32, kernels vs plain attention, 3 adamw steps at lr 1e-4):
# losses and grad norms relative; what the steps moved each leaf by
# (p3 - p0), norm-wise relative per leaf (||a - b|| / ||b||).  Not
# elementwise: Adam normalises every element's step to about lr, so an
# element whose gradient nearly cancels turns summation-order noise into a
# step difference of up to lr (the largest is reported).
TOL_TRAIN_EXACT = {"loss": 1e-5, "grad_norm": 1e-5, "params_moved": 1e-3}
# train at full width and depth, bf16, B=2, one forward and backward:
# kernel path vs plain attention, relative.  Both round attention outputs
# and gradients to bf16 at other places; the difference compounds over 24
# layers.  attn_grad is the worst ||a - b|| / ||b|| over every layer's wq,
# wk, wv and wo gradient; each fault of PLANTED_FAULTS must exceed it.  On
# an H100 the clean reading is 2.4e-2 (wq of layer 0, where the most
# layers' rounding has compounded) and the mildest planted fault reads
# 0.107; 5e-2 sits about 2x from each.
TOL_TRAIN_BF16 = {"loss": 1e-3, "grad_norm": 5e-3, "attn_grad": 5e-2}
# The JAX package's training-benchmark config (bench.py:3384-3390): 1.36B
# parameters, bf16 params and adam state, full remat, flash attention,
# batch 12 x 2048, adamw at lr 1e-4.
TRAIN_CFG = dict(vocab_size=32000, hidden=2048, layers=24, heads=16,
                 kv_heads=16, head_dim=128, mlp_dim=5632, max_seq_len=2048)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 12, 2048, 1e-4


def _train_attn_case():
    """The attention shape of that config's training step, as a
    kernel_check case (B, H, Hkv, Sq, Sk, D, dtype, causal, q_offset)."""
    import torch
    return (TRAIN_BATCH, TRAIN_CFG["heads"], TRAIN_CFG["kv_heads"],
            TRAIN_SEQ, TRAIN_SEQ, TRAIN_CFG["head_dim"], torch.bfloat16,
            True, 0)


def _d32_attn_case():
    """A D 32 attention case the planted faults are held at: the training
    case's sequence, four query heads of llama_tiny's width a batch row
    (B 16 keeps the launch wide), bf16."""
    import torch
    return (16, 4, 4, TRAIN_SEQ, TRAIN_SEQ, 32, torch.bfloat16, True, 0)


def _planted_cases():
    """The kernel_check cases the planted faults are held at: D 128 (the
    training shape) and D 32."""
    return (_train_attn_case(), _d32_attn_case())


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def check_share(share, what: str) -> None:
    """An idle share must lie in [0, 1): a profiler window whose kernel
    time sums past its wall misread the device (such windows have read
    -985), and its numbers are not kept."""
    check(share is None or 0.0 <= share < 1.0,
          f"{what}: an idle share outside [0, 1): {share}")


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, from
    CUDA events after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def eager_ms(fn, iters: int, repeats: int = 5) -> float:
    """The least of ``repeats`` readings of ``time_ms``: the per-call cost
    of an eager caller, host cost included, with less of the noise that
    other load on the machine's CPU adds to any one reading."""
    return min(time_ms(fn, iters) for _ in range(repeats))


def graph_ms(fn, calls: int = 10, replays: int = 10) -> float:
    """Mean device time of ``fn`` from CUDA events around replays of a CUDA
    graph holding ``calls`` calls of it: the kernels alone, without the
    host's per-call cost, which at small shapes exceeds the kernel's.  The
    warm-up call runs on the capture stream, as PyTorch asks: it also
    allocates paged_decode's workspace for that stream, which a capture
    never does."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def pct(xs, q):
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q))


# ---------------------------------------------------------------- phases

def phase_device():
    import torch
    from ray_tpu_torch._device import card_power_line
    check(torch.cuda.is_available(), "no CUDA device visible")
    smi = card_power_line(0)
    check(smi is not None, "nvidia-smi did not report the card")
    print(smi, flush=True)
    info = {"phase": "device", "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "nvidia_smi": smi}
    emit(info)
    return info


# Every __global__ kernel of ray_tpu_torch/csrc (tests/test_torch_build.py
# holds this list to the sources).  The two *_wgmma_check_kernel are the
# test-only one-wgmma checks of tests/test_torch_kernels.py.
KERNEL_NAMES = ("flash_fwd_wgmma_kernel", "flash_fwd_wgmma_check_kernel",
                "flash_fwd_f32_kernel",
                "flash_bwd_dq_wgmma_kernel", "flash_bwd_dq_f32_kernel",
                "flash_bwd_dkv_wgmma_kernel", "flash_bwd_dkv_f32_kernel",
                "flash_bwd_wgmma_check_kernel", "paged_decode_split_kernel")
# Kernels whose registers must all be their own: a spill of their
# accumulators to local memory would cost more than the kernel gains.
NO_SPILL = ("flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
            "flash_bwd_dkv_wgmma_kernel", "paged_decode_split_kernel")


def _ptxas_summary(lines):
    """nvcc -Xptxas -v output -> one "kernel<args>: regs, smem, spills"
    string per compiled kernel."""
    out, cur = [], None
    for ln in lines:
        m = re.search(r"entry function '(\S+)'", ln)
        if m:
            mangled = m.group(1)
            name = next((k for k in KERNEL_NAMES if k + "I" in mangled),
                        mangled)
            args = re.findall(r"Li(\d+)E", mangled)
            if "bfloat16" in mangled:
                args.insert(0, "bf16")
            elif "_kernelIf" in mangled:
                args.insert(0, "f32")
            cur = {"kernel": f"{name}<{','.join(args)}>"}
            out.append(cur)
        elif cur is not None:
            for key, pat in (("regs", r"Used (\d+) registers"),
                             ("smem", r"(\d+) bytes smem"),
                             ("spill_stores", r"(\d+) bytes spill stores")):
                m = re.search(pat, ln)
                if m:
                    cur[key] = int(m.group(1))
    return [f"{k['kernel']}: {k.get('regs')} regs, {k.get('smem', 0)} B "
            f"static smem, {k.get('spill_stores', 0)} B spilled"
            for k in out]


def phase_build():
    from ray_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build()
    seconds = time.perf_counter() - t0
    summary = _ptxas_summary(_build.ptxas_lines())
    emit({"phase": "build", "seconds": round(seconds, 2),
          "cached": not _build.build_log, "ptxas": summary})
    spilled = [ln for ln in summary if ln.split("<")[0] in NO_SPILL
               and not ln.endswith(" 0 B spilled")]
    check(not spilled, f"kernels spill registers: {spilled}")


def _flash_inputs(B, H, Hkv, Sq, Sk, D, dtype, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    return rnd(B, H, Sq, D), rnd(B, Hkv, Sk, D), rnd(B, Hkv, Sk, D)


def _paged_inputs(B, H, Hkv, D, page, lens, dtype, seed, P=None):
    """kv_pages over shuffled pages, [B, P] block tables naming each slot's
    pages (P: the longest length's pages unless given), int32 seq_lens."""
    import torch
    rng = np.random.default_rng(seed)
    P = P or max(1, math.ceil(max(lens) / page))
    NP = B * P + 1
    perm = rng.permutation(np.arange(1, NP)).astype(np.int32)
    bt = perm[:B * P].reshape(B, P)
    g = torch.Generator(device="cuda").manual_seed(seed)
    kv = torch.randn(NP, page, 2 * Hkv, D, generator=g,
                     device="cuda").to(dtype)
    q = torch.randn(B, H, D, generator=g, device="cuda").to(dtype)
    return (q, kv, torch.from_numpy(bt).cuda(),
            torch.tensor(lens, dtype=torch.int32, device="cuda"))


def row_rel_err(out, ref, floor: float = 0.0) -> float:
    """Worst over rows of ||out - ref|| / ||ref|| along D, a row's ||ref||
    taken as at least ``floor`` times the largest row's."""
    a, b = out.float(), ref.float()
    norm = b.norm(dim=-1)
    least = max(floor * norm.max().item(), 1e-30)
    return ((a - b).norm(dim=-1) / norm.clamp_min(least)).max().item()


def planted_fwd_faults(q, k, v, out, ref):
    """PLANTED_FWD_FAULTS in a copy of ``out`` (causal, Sq = Sk >= 256):
    {fault: (max abs error, row_rel_err)} against ``ref``."""
    import torch
    from ray_tpu_torch.ops.attention import reference_attention
    S = q.shape[2]
    skip = out.clone()
    # The last tile's rows without keys 128-255: the other keys keep their
    # order, so the diagonal moves 128 down.
    drop = [torch.cat((t[:, :, :128], t[:, :, 256:]), dim=2) for t in (k, v)]
    skip[:, :, -128:] = reference_attention(q[:, :, -128:], *drop,
                                            causal=True, q_offset=S - 256)
    big = out.clone()
    big[:, :, -128:] *= 1.05
    return {name: ((f.float() - ref.float()).abs().max().item(),
                   row_rel_err(f, ref))
            for name, f in zip(PLANTED_FWD_FAULTS, (skip, big))}


def planted_paged_faults(q, kv, bt, sl, page, out, ref, splits):
    """PLANTED_PAGED_FAULTS in copies of ``out``, on the live slot with the
    most non-empty splits (of those, the fullest last page), each computed
    by the plain versions: {fault: (max abs error, row_rel_err over the
    live rows)} against ``ref``."""
    from ray_tpu_torch.ops.paged_attention import (_exact_path,
                                                   _merge_partials,
                                                   _split_partials,
                                                   split_ranges)
    P = bt.shape[1]
    lo, hi = split_ranges(sl, P, page, splits)
    n_splits = (hi > lo).sum(dim=0)
    reach = sl.long().clamp(max=P * page)
    last_fill = (reach - 1) % page + 1
    b = int((n_splits * (page + 1) + last_fill * (reach > 0)).argmax())
    check(int(n_splits[b]) > 1 and int(reach[b]) > page,
          f"planted_paged_faults: slot {b} has one split or one page")
    one = (q[b:b + 1], kv, bt[b:b + 1], sl[b:b + 1], page)
    m, l, acc = _split_partials(*one, splits)
    last = int(n_splits[b]) - 1
    m[last], l[last], acc[last] = -math.inf, 0.0, 0.0
    dropped = _merge_partials(m, l, acc, q.dtype)
    short = sl[b:b + 1].clone()
    short[0] = (int(reach[b]) - 1) // page * page
    skipped = _exact_path(*one[:3], short, page)
    live = sl > 0
    res = {}
    for name, row in zip(PLANTED_PAGED_FAULTS, (dropped, skipped)):
        f = out.clone()
        f[b] = row[0]
        res[name] = ((f[live].float() - ref[live].float()).abs().max()
                     .item(), row_rel_err(f[live], ref[live]))
    return res


def planted_bwd_faults(got, ref):
    """PLANTED_BWD_FAULTS in copies of ``got`` = (dq, dk, dv): {fault:
    (max abs error over the largest magnitude, row_rel_err)}, the worst
    over the gradients it touches, against ``ref``."""
    def edge(t, factor):                  # the last 128 rows of each head
        f = t.clone()
        f[:, :, -128:] *= factor
        return f

    dq, dk, dv = got
    cases = dict(zip(PLANTED_BWD_FAULTS, (
        [(edge(dk, 0.0), ref[1]), (edge(dv, 0.0), ref[2])],
        [(edge(dk, 1.05), ref[1]), (edge(dv, 1.05), ref[2])],
        [(edge(dq, 1.05), ref[0])])))
    return {name: (max(_grad_errs(f, r)[1] for f, r in pairs),
                   max(row_rel_err(f, r, BWD_ROW_FLOOR) for f, r in pairs))
            for name, pairs in cases.items()}


def phase_kernel_check():
    import torch
    from ray_tpu_torch.ops.attention import (_scores, flash_fwd,
                                             reference_attention)
    results = {"flash": []}
    failed = []
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for D in (128, 64, 32):
            for S in (256, 1000, 2048):
                for causal in (True, False):
                    cases.append((1, 16, 8, S, S, D, dtype, causal, 0))
        # q_offset: a query block that starts mid-sequence.
        cases.append((1, 16, 8, 256, 1000, 128, dtype, True, 744))
        cases.append((2, 16, 8, 1000, 2048, 64, dtype, True, 1048))
        # The bf16 kernel's 128-row / 128-key tiles at their edges.
        cases.append((1, 16, 8, 129, 129, 128, dtype, True, 0))
        cases.append((2, 16, 8, 1, 300, 64, dtype, True, 299))
        cases.append((1, 16, 16, 300, 400, 128, dtype, True, 100))
        # D 32 (llama_tiny's heads) at a query offset and the tile edges.
        cases.append((2, 4, 2, 1000, 2048, 32, dtype, True, 1048))
        cases.append((1, 4, 2, 129, 129, 32, dtype, True, 0))
    # The shapes the planted faults are held at (the training path's
    # forward: out and LSE).
    cases += list(_planted_cases())
    for i, (B, H, Hkv, Sq, Sk, D, dtype, causal, qo) in enumerate(cases):
        q, k, v = _flash_inputs(B, H, Hkv, Sq, Sk, D, dtype, seed=i)
        out, lse = flash_fwd(q, k, v, causal=causal, q_offset=qo,
                             need_lse=True)
        ref = reference_attention(q, k, v, causal=causal, q_offset=qo)
        ref_lse = torch.logsumexp(
            _scores(q, k, causal, 1.0 / math.sqrt(D), qo), dim=-1)
        torch.cuda.synchronize()
        name = str(dtype).split(".")[-1]
        err = (out.float() - ref.float()).abs().max().item()
        rel = row_rel_err(out, ref)
        lse_err = (lse - ref_lse).abs().max().item()
        row = {"dtype": name, "B": B, "H": H, "Hkv": Hkv, "Sq": Sq,
               "Sk": Sk, "D": D, "causal": causal, "q_offset": qo,
               "max_abs_err": err, "row_rel_err": rel,
               "lse_max_abs_err": lse_err, "tol": TOL[name],
               "tol_row_rel": TOL_ROW_REL[name]}
        if (B, H, Hkv, Sq, Sk, D, dtype, causal, qo) in _planted_cases():
            # The limit has to see a fault on the long rows alone.
            row["planted"] = planted_fwd_faults(q, k, v, out, ref)
            if min(r for _a, r in row["planted"].values()) <= \
                    TOL_ROW_REL[name]:
                failed.append(("flash_fwd planted fault passed", row))
        results["flash"].append(row)
        if not (err <= TOL[name] and rel <= TOL_ROW_REL[name]
                and lse_err <= 1e-3):
            failed.append(("flash_fwd", row))
    results["paged"] = _check_paged(failed)
    results["flash_bwd"] = _check_flash_bwd(failed)
    for kind in ("flash", "paged", "flash_bwd"):
        emit({"phase": "kernel_check", "kernel": kind,
              "cases": results[kind]})
    check(not failed, f"kernels disagree with their plain versions: {failed}")


# paged_decode's kernel_check cases: (B, H, Hkv, D, dtype, lens, P, plant).
# P None: the longest length's pages.  plant: hold PLANTED_PAGED_FAULTS to
# the row limit there (cases the split rule splits).
def _paged_cases():
    import torch
    rng = np.random.default_rng(0)
    cases = []
    for H, Hkv, D, dtype in ((16, 8, 128, torch.bfloat16),
                             (16, 8, 128, torch.float32),
                             (8, 2, 64, torch.bfloat16),
                             (8, 8, 64, torch.float32),
                             (4, 2, 32, torch.bfloat16),
                             (4, 2, 32, torch.float32)):
        lens = rng.integers(1, 401, size=32).tolist()
        lens[5] = 0                       # an inactive slot
        cases.append((32, H, Hkv, D, dtype, lens, None, False))
    for dtype in (torch.bfloat16, torch.float32):
        bf16 = dtype == torch.bfloat16
        # The engine's table width (llama_1b: P = 128) at serving's lengths.
        cases.append((32, 16, 8, 128, dtype,
                      rng.integers(256, 385, size=32).tolist(), 128, False))
        # Long context: one slot at llama_1b's max_seq_len, 32 splits.
        cases.append((1, 16, 8, 128, dtype, [2048], 128, bf16))
        # Edge lengths at a table of 8 pages, GQA 8.
        cases.append((12, 32, 4, 128, dtype,
                      [1, 16, 17, 31, 32, 33, 63, 64, 65, 128, 200, 0], 8,
                      False))
    cases.append((4, 16, 8, 128, torch.bfloat16,
                  rng.integers(1000, 2049, size=4).tolist(), 128, True))
    # D 32 (llama_tiny's heads) split, with the planted faults.
    for dtype in (torch.bfloat16, torch.float32):
        cases.append((4, 4, 2, 32, dtype,
                      rng.integers(1000, 2049, size=4).tolist(), 128, True))
    # The 7B preset's heads (G 1).
    cases.append((8, 32, 32, 128, torch.bfloat16,
                  rng.integers(512, 1025, size=8).tolist(), 128, False))
    # One long context as the engine sends it: 32 slots, 31 inactive.
    cases.append((32, 16, 8, 128, torch.bfloat16, [2048] + [0] * 31, 128,
                  False))
    return cases


def _check_paged(failed):
    """paged_decode against _exact_path on the same inputs (TOL and
    TOL_PAGED_ROW_REL over the live slots; inactive slots finite zeros),
    with PLANTED_PAGED_FAULTS at long context (one slot, 32 splits) and
    at B 4 (8 splits)."""
    import torch
    from ray_tpu_torch.ops import paged_attention as paged
    rows = []
    for j, (B, H, Hkv, D, dtype, lens, P, plant) in enumerate(
            _paged_cases()):
        q, kv, bt, sl = _paged_inputs(B, H, Hkv, D, 16, lens, dtype,
                                      seed=100 + j, P=P)
        out = paged.paged_decode(q, kv, bt, sl, 16)
        ref = paged._exact_path(q, kv, bt, sl, 16)
        torch.cuda.synchronize()
        live = sl > 0
        name = str(dtype).split(".")[-1]
        err = (out[live].float() - ref[live].float()).abs().max().item()
        rel = row_rel_err(out[live], ref[live])
        zeros = bool((out[~live] == 0).all().item())
        splits = paged._splits(q.device, B, Hkv, bt.shape[1])
        row = {"dtype": name, "B": B, "H": H, "Hkv": Hkv, "D": D,
               "page": 16, "P": bt.shape[1], "splits": splits,
               "seq_lens": [min(lens), max(lens)], "max_abs_err": err,
               "row_rel_err": rel, "inactive_zeros": zeros,
               "tol": TOL[name], "tol_row_rel": TOL_PAGED_ROW_REL[name]}
        if plant:
            row["planted"] = planted_paged_faults(q, kv, bt, sl, 16, out,
                                                  ref, splits)
            if min(r for _a, r in row["planted"].values()) <= \
                    TOL_PAGED_ROW_REL[name]:
                failed.append(("paged_decode planted fault passed", row))
        rows.append(row)
        if not (err <= TOL[name] and rel <= TOL_PAGED_ROW_REL[name]
                and zeros):
            failed.append(("paged_decode", row))
        del q, kv, bt, sl, out, ref
    return rows


def _bwd_inputs(B, H, Hkv, Sq, Sk, D, dtype, causal, q_offset, seed):
    """q, k, v, the flash forward's out and LSE, and an upstream gradient."""
    import torch
    from ray_tpu_torch.ops.attention import flash_fwd
    q, k, v = _flash_inputs(B, H, Hkv, Sq, Sk, D, dtype, seed)
    out, lse = flash_fwd(q, k, v, causal=causal, q_offset=q_offset,
                         need_lse=True)
    g = torch.Generator(device="cuda").manual_seed(seed + 10_000)
    dout = torch.randn(B, H, Sq, D, generator=g, device="cuda").to(dtype)
    return q, k, v, out, lse, dout


def _grad_errs(got, ref):
    """(max abs error, max abs error over the reference's largest
    magnitude) of one gradient."""
    diff = (got.float() - ref.float()).abs().max().item()
    return diff, diff / max(ref.float().abs().max().item(), 1e-6)


def _check_flash_bwd(failed):
    """dq, dk and dv of flash_bwd against _flash_bwd_plain on the same
    inputs (TOL_BWD and TOL_BWD_ROW_REL): bf16 and fp32, D 32, 64 and 128,
    causal and full, H/Hkv 16/16, 16/8 and 8/2, S 256, 1000 and 2048,
    q_offset > 0 with Sq != Sk, and the training shape and a D 32 one with
    PLANTED_BWD_FAULTS."""
    import torch
    from ray_tpu_torch.ops.attention import _flash_bwd_plain, flash_bwd
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for D in (128, 64, 32):
            for causal in (True, False):
                for H, Hkv in ((16, 16), (16, 8), (8, 2)):
                    for S in (256, 1000, 2048):
                        cases.append((1, H, Hkv, S, S, D, dtype, causal, 0))
        cases.append((1, 16, 8, 256, 1000, 128, dtype, True, 744))
        cases.append((2, 8, 2, 1000, 2048, 64, dtype, True, 1048))
        cases.append((2, 4, 2, 1000, 2048, 32, dtype, True, 1048))
    cases += list(_planted_cases())
    out_rows = []
    for i, (B, H, Hkv, Sq, Sk, D, dtype, causal, qo) in enumerate(cases):
        q, k, v, out, lse, dout = _bwd_inputs(B, H, Hkv, Sq, Sk, D, dtype,
                                              causal, qo, seed=500 + i)
        got = flash_bwd(q, k, v, out, lse, dout, causal=causal, q_offset=qo)
        ref = _flash_bwd_plain(q, k, v, out, lse, dout, causal,
                               1.0 / math.sqrt(D), qo)
        torch.cuda.synchronize()
        name = str(dtype).split(".")[-1]
        errs = {g: _grad_errs(a, r) for g, a, r in zip(("dq", "dk", "dv"),
                                                         got, ref)}
        rel = {g: row_rel_err(a, r, BWD_ROW_FLOOR)
               for g, a, r in zip(("dq", "dk", "dv"), got, ref)}
        row = {"dtype": name, "B": B, "H": H, "Hkv": Hkv, "Sq": Sq,
               "Sk": Sk, "D": D, "causal": causal, "q_offset": qo,
               "max_abs_err": {g: e[0] for g, e in errs.items()},
               "max_rel_err": {g: e[1] for g, e in errs.items()},
               "row_rel_err": rel, "tol_rel": TOL_BWD[name],
               "tol_row_rel": TOL_BWD_ROW_REL[name]}
        if (B, H, Hkv, Sq, Sk, D, dtype, causal, qo) in _planted_cases():
            # The row limit has to see a fault on the edge tiles alone.
            row["planted"] = planted_bwd_faults(got, ref)
            if min(r for _a, r in row["planted"].values()) <= \
                    TOL_BWD_ROW_REL[name]:
                failed.append(("flash_bwd planted fault passed", row))
        out_rows.append(row)
        finite = all(bool(torch.isfinite(a.float()).all()) for a in got)
        if not (finite and max(e[1] for e in errs.values()) <= TOL_BWD[name]
                and max(rel.values()) <= TOL_BWD_ROW_REL[name]):
            failed.append(("flash_bwd", row))
    del q, k, v, out, lse, dout, got, ref
    out_rows.append(_check_flash_grad_end_to_end(failed))
    return out_rows


def _check_flash_grad_end_to_end(failed):
    """At the training path's attention shape: the gradients of
    flash_attention (flash_fwd's out and LSE, then flash_bwd, through
    autograd) against autograd of the plain attention in fp32 on the same
    bf16 inputs.  Nothing of the kernels' forward feeds the reference."""
    import torch
    from ray_tpu_torch.ops.attention import (flash_attention,
                                             reference_attention)
    B, H, Hkv, Sq, Sk, D, dtype, causal, qo = _train_attn_case()
    q, k, v = _flash_inputs(B, H, Hkv, Sq, Sk, D, dtype, seed=900)
    g = torch.Generator(device="cuda").manual_seed(901)
    dout = torch.randn(B, H, Sq, D, generator=g, device="cuda").to(dtype)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(flash_attention(*leaves, causal=causal),
                              leaves, dout)
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    ref = torch.autograd.grad(
        reference_attention(*leaves, causal=causal), leaves, dout.float())
    torch.cuda.synchronize()
    errs = {n: _grad_errs(a, r) for n, a, r in zip(("dq", "dk", "dv"),
                                                   got, ref)}
    row = {"check": "flash_attention grads vs autograd of fp32 plain",
           "dtype": "bfloat16", "B": B, "H": H, "Hkv": Hkv, "Sq": Sq,
           "Sk": Sk, "D": D, "causal": causal, "q_offset": qo,
           "max_abs_err": {n: e[0] for n, e in errs.items()},
           "max_rel_err": {n: e[1] for n, e in errs.items()},
           "tol_rel": TOL_BWD["bfloat16"]}
    finite = all(bool(torch.isfinite(a.float()).all()) for a in got)
    if not (finite and max(e[1] for e in errs.values())
            <= TOL_BWD["bfloat16"]):
        failed.append(("flash_attention grad", row))
    return row


def phase_kernel_time(smi):
    import torch
    import torch.nn.functional as F
    from ray_tpu_torch.ops.attention import flash_fwd, reference_attention
    rows = {}
    # Serving's prefill shapes (llama_1b: H 16 / Hkv 8), then the training
    # step's (need_lse, as the training path calls it).  The kernel and SDPA
    # are timed twice: by graph replay (ms, library_ms: device time) and
    # eager (eager_ms, library_eager_ms: back-to-back calls, host cost
    # included, which is what serving's eager prefill pays; the least of
    # five readings).  The plain version eager.
    train = _train_attn_case()
    for key, (B, H, Hkv, S, D), iters, lse in (
            ("flash_fwd_S256", (1, 16, 8, 256, 128), 200, False),
            ("flash_fwd_S2048", (1, 16, 8, 2048, 128), 50, False),
            ("flash_fwd_train", (train[0], train[1], train[2], train[3],
                                 train[5]), 20, True)):
        q, k, v = _flash_inputs(B, H, Hkv, S, S, D, torch.bfloat16, seed=7)
        err = (flash_fwd(q, k, v, causal=True)[0].float() - reference_attention(
            q, k, v, causal=True).float()).abs().max().item()

        def kernel():
            return flash_fwd(q, k, v, causal=True, need_lse=lse)

        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)

        ms, lib = graph_ms(kernel), graph_ms(sdpa)
        eager, lib_eager = eager_ms(kernel, iters), eager_ms(sdpa, iters)
        plain = time_ms(lambda: reference_attention(q, k, v, causal=True),
                        max(5, iters // 10))
        pairs = S * (S + 1) // 2                  # causal (q, k) pairs
        flops = 4 * B * H * D * pairs
        # q, k, v read once, o written once (and the fp32 LSE).
        nbytes = (2 * (2 * B * H * S * D + 2 * B * Hkv * S * D)
                  + (4 * B * H * S if lse else 0))
        rows[key] = dict(_timing_row(
            "flash_fwd", {"B": B, "H": H, "Hkv": Hkv, "S": S, "D": D,
                          "dtype": "bfloat16", "causal": True,
                          "need_lse": lse},
            ms, plain, lib, flops, nbytes, err), timed_by="graph",
            eager_ms=eager, library_eager_ms=lib_eager)
        del q, k, v
    _time_paged(rows)
    _time_flash_bwd(rows)
    _time_d32(rows)
    for row in rows.values():
        emit(dict(row, phase="kernel_time", card=smi))
    return rows


# paged_decode's timed shapes (kernel_time, paged_decode_ab.py): key, B, H,
# Hkv, lengths drawn from [lo, hi] for the first `live` slots (the rest
# inactive, length 0), live; D 128, page 16, bf16, at the engine's table
# width for llama_1b (P = 128).  (a) serving's decode; (b) one long
# context; (c) a few long ones; (d) the 7B preset's heads (G 1); (e) one
# long context as the engine sends it: all 32 slots, 31 of them inactive.
PAGED_SHAPES = (("paged_decode", 32, 16, 8, (256, 384), 32),
                ("paged_decode_long", 1, 16, 8, (2048, 2048), 1),
                ("paged_decode_B4", 4, 16, 8, (1000, 2048), 4),
                ("paged_decode_g1", 8, 32, 32, (512, 1024), 8),
                ("paged_decode_long_B32", 32, 16, 8, (2048, 2048), 1))
PAGED_D, PAGED_PAGE, PAGED_P = 128, 16, 128
L2_BYTES = 50e6


def paged_shape_inputs(B, H, Hkv, lens_range, live, seed, copies=None):
    """One PAGED_SHAPES row's inputs: (copies, lens), copies being (unless
    given) enough caches of the same lengths that, rotated, their live
    bytes exceed twice the L2 (a decode step walks 16 layers' caches: none
    is in L2)."""
    import torch
    lens = np.random.default_rng(seed).integers(
        lens_range[0], lens_range[1] + 1, size=live).tolist()
    lens += [0] * (B - live)
    live = sum(lens) * 2 * Hkv * PAGED_D * 2
    n = copies or max(2, math.ceil(2 * L2_BYTES / live))
    return [_paged_inputs(B, H, Hkv, PAGED_D, PAGED_PAGE, lens,
                          torch.bfloat16, seed=seed + i, P=PAGED_P)
            for i in range(n)], lens


def paged_bound(B, H, Hkv, lens):
    """(flops, bytes) the kernel must do and move: 4*D flops per live
    token and query head; live K/V, q, out, the live block-table entries
    and seq_lens, each once."""
    live = int(sum(lens))
    pages = sum(math.ceil(n / PAGED_PAGE) for n in lens)
    return (4 * H * PAGED_D * live,
            live * 2 * Hkv * PAGED_D * 2 + 2 * B * H * PAGED_D * 2
            + pages * 4 + B * 4)


def rotating(call, copies):
    """A call of ``call(*copies[i])`` taking the copies in turn."""
    turn = [0]

    def run():
        args = copies[turn[0] % len(copies)]
        turn[0] += 1
        return call(*args)

    return run


def _time_paged(rows):
    """paged_decode at PAGED_SHAPES: by graph replay (ms) and eager
    (eager_ms), the caches rotated past the L2; the plain version eager on
    one copy.  No one-call PyTorch equivalent exists."""
    import torch
    from ray_tpu_torch.ops import paged_attention as paged
    for key, B, H, Hkv, lens_range, live in PAGED_SHAPES:
        copies, lens = paged_shape_inputs(B, H, Hkv, lens_range, live,
                                          seed=200)

        def kernel(q, kv, bt, sl):
            return paged.paged_decode(q, kv, bt, sl, PAGED_PAGE)

        run = rotating(kernel, copies)
        calls = len(copies) * math.ceil(10 / len(copies))
        ms = graph_ms(run, calls=calls)
        eager = eager_ms(run, 200)
        q, kv, bt, sl = copies[0]
        on = sl > 0
        err = (kernel(q, kv, bt, sl)[on].float() - paged._exact_path(
            q, kv, bt, sl, PAGED_PAGE)[on].float()).abs().max().item()
        plain = time_ms(lambda: paged._exact_path(q, kv, bt, sl,
                                                  PAGED_PAGE), 5)
        flops, nbytes = paged_bound(B, H, Hkv, lens)
        rows[key] = dict(_timing_row(
            "paged_decode", {"B": B, "H": H, "Hkv": Hkv, "D": PAGED_D,
                             "page": PAGED_PAGE, "P": PAGED_P,
                             "seq_lens": [min(lens), max(lens)],
                             "dtype": "bfloat16"},
            ms, plain, None, flops, nbytes, err), timed_by="graph",
            eager_ms=eager, splits=paged._splits(q.device, B, Hkv, PAGED_P),
            cache_copies=len(copies),
            library="none (no one-call PyTorch equivalent)")
        del copies, q, kv, bt, sl
        torch.cuda.empty_cache()


def sdpa_bwd(q, k, v, dout):
    """SDPA's backward alone, as one call for the timers (the yardstick;
    the port never calls SDPA): (call, name of the backward node of the
    backend SDPA picked).  The forward runs once inside a captured CUDA
    graph, so autograd records it on the capture stream; each call is one
    ``autograd.grad`` through that backend's backward op, which a graph
    capture on the same stream (``graph_ms``) holds as it is."""
    import torch
    import torch.nn.functional as F
    qkv = [t.detach().clone().requires_grad_() for t in (q, k, v)]

    def fwd():
        return F.scaled_dot_product_attention(*qkv, is_causal=True,
                                              enable_gqa=True)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):           # warm-up, as capture asks
        torch.autograd.grad(fwd(), qkv, dout)
    torch.cuda.current_stream().wait_stream(side)
    fwd_graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(fwd_graph):
        out = fwd()
    fwd_graph.replay()

    def call(_keep=fwd_graph):
        return torch.autograd.grad(out, qkv, dout, retain_graph=True)

    return call, out.grad_fn.name()


def _time_flash_bwd(rows):
    """flash_bwd_dq and flash_bwd_dkv (bf16, causal, S 2048, D 128) at B=1
    with H=Hkv=16 and GQA 16/8, and at the training step's shape (B 12,
    H=Hkv=16): by graph replay (ms, library_ms) and eager (eager_ms,
    library_eager_ms), SDPA's backward beside them (sdpa_bwd)."""
    import torch
    from ray_tpu_torch.ops.attention import (_flash_bwd_plain, flash_bwd,
                                             flash_bwd_dkv, flash_bwd_dq)
    train = _train_attn_case()
    S, D = train[3], train[5]
    scale = 1.0 / math.sqrt(D)
    for B, H, Hkv, tag, iters in ((1, 16, 16, "", 30),
                                  (1, 16, 8, "_gqa16_8", 30),
                                  (train[0], train[1], train[2], "_train",
                                   5)):
        q, k, v, out, lse, dout = _bwd_inputs(B, H, Hkv, S, S, D,
                                              torch.bfloat16, True, 0, 11)
        kw = dict(causal=True, scale=scale, q_offset=0)
        got = flash_bwd(q, k, v, out, lse, dout, **kw)
        ref = _flash_bwd_plain(q, k, v, out, lse, dout, True, scale, 0)
        errs = [_grad_errs(a, r) for a, r in zip(got, ref)]
        del got, ref
        delta = flash_bwd_dq(q, k, v, out, dout, lse, **kw)[1]

        def dq():
            return flash_bwd_dq(q, k, v, out, dout, lse, **kw)

        def dkv():
            return flash_bwd_dkv(q, k, v, dout, lse, delta, **kw)

        calls = 5 if B > 1 else 10
        dq_ms, dkv_ms = graph_ms(dq, calls), graph_ms(dkv, calls)
        dq_eager, dkv_eager = eager_ms(dq, iters), eager_ms(dkv, iters)
        # The plain version computes dq, dk and dv together: one time for
        # both rows.  So does SDPA's backward.
        plain = time_ms(lambda: _flash_bwd_plain(q, k, v, out, lse, dout,
                                                 True, scale, 0), 3)
        sdpa, backend = sdpa_bwd(q, k, v, dout)
        lib, lib_eager = graph_ms(sdpa, calls), eager_ms(sdpa, iters)
        del sdpa
        pairs = S * (S + 1) // 2                  # causal (q, k) pairs
        # Read once: q, dO, k, v (bf16) and LSE (fp32); dq also reads O
        # and writes delta, dk/dv reads delta.
        reads = 2 * (2 * B * H * S * D + 2 * B * Hkv * S * D) + 4 * B * H * S
        shape = {"B": B, "H": H, "Hkv": Hkv, "S": S, "D": D,
                 "dtype": "bfloat16", "causal": True}
        note = {"plain_and_library_cover": "dq, dk and dv together",
                "library": f"SDPA backward ({backend})"}
        rows[f"flash_bwd_dq{tag}"] = dict(_timing_row(
            "flash_bwd_dq", shape, dq_ms, plain, lib, 6 * B * H * D * pairs,
            reads + 2 * B * H * S * D + 2 * B * H * S * D + 4 * B * H * S,
            errs[0][0]), timed_by="graph", eager_ms=dq_eager,
            library_eager_ms=lib_eager, max_rel_err=errs[0][1], **note)
        rows[f"flash_bwd_dkv{tag}"] = dict(_timing_row(
            "flash_bwd_dkv", shape, dkv_ms, plain, lib,
            8 * B * H * D * pairs,
            reads + 4 * B * H * S + 2 * 2 * B * Hkv * S * D,
            max(errs[1][0], errs[2][0])), timed_by="graph",
            eager_ms=dkv_eager, library_eager_ms=lib_eager,
            max_rel_err=max(errs[1][1], errs[2][1]), **note)
        del q, k, v, out, lse, dout, delta
        torch.cuda.empty_cache()


# The D 32 instances' timed shapes, those their main paths give them:
# training at bench.py's small config (B 4, S 256, H = Hkv = 4), serving
# llama_tiny (H 4, Hkv 2) over 8 slots at the engine's table width
# (max_seq_len 256 / page 16).
D32_TRAIN = (4, 4, 4, 256, 32)
D32_PAGED = (8, 4, 2, (64, 160), 16)


def _time_d32(rows):
    """The D 32 instances of all four kernels, bf16, by graph replay (ms,
    library_ms) and eager (eager_ms, library_eager_ms), the plain versions
    eager, at D32_TRAIN and D32_PAGED."""
    import torch
    import torch.nn.functional as F
    from ray_tpu_torch.ops import paged_attention as paged
    from ray_tpu_torch.ops.attention import (_flash_bwd_plain, flash_bwd,
                                             flash_bwd_dkv, flash_bwd_dq,
                                             flash_fwd, reference_attention)
    B, H, Hkv, S, D = D32_TRAIN
    shape = {"B": B, "H": H, "Hkv": Hkv, "S": S, "D": D,
             "dtype": "bfloat16", "causal": True}
    pairs = S * (S + 1) // 2
    q, k, v, out, lse, dout = _bwd_inputs(B, H, Hkv, S, S, D, torch.bfloat16,
                                          True, 0, 13)
    kw = dict(causal=True, scale=1.0 / math.sqrt(D), q_offset=0)

    def fwd():
        return flash_fwd(q, k, v, causal=True, need_lse=True)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)

    err = (fwd()[0].float() - reference_attention(q, k, v).float()
           ).abs().max().item()
    plain = time_ms(lambda: reference_attention(q, k, v), 20)
    nbytes = 2 * (2 * B * H * S * D + 2 * B * Hkv * S * D) + 4 * B * H * S
    rows["flash_fwd_d32"] = dict(_timing_row(
        "flash_fwd", dict(shape, need_lse=True), graph_ms(fwd), plain,
        graph_ms(sdpa), 4 * B * H * D * pairs, nbytes, err),
        timed_by="graph", eager_ms=eager_ms(fwd, 100),
        library_eager_ms=eager_ms(sdpa, 100))
    got = flash_bwd(q, k, v, out, lse, dout, **kw)
    ref = _flash_bwd_plain(q, k, v, out, lse, dout, True, kw["scale"], 0)
    errs = [_grad_errs(a, r) for a, r in zip(got, ref)]
    delta = flash_bwd_dq(q, k, v, out, dout, lse, **kw)[1]

    def dq():
        return flash_bwd_dq(q, k, v, out, dout, lse, **kw)

    def dkv():
        return flash_bwd_dkv(q, k, v, dout, lse, delta, **kw)

    plain = time_ms(lambda: _flash_bwd_plain(q, k, v, out, lse, dout, True,
                                             kw["scale"], 0), 10)
    sdpa_b, backend = sdpa_bwd(q, k, v, dout)
    lib, lib_eager = graph_ms(sdpa_b), eager_ms(sdpa_b, 50)
    reads = 2 * (2 * B * H * S * D + 2 * B * Hkv * S * D) + 4 * B * H * S
    note = {"plain_and_library_cover": "dq, dk and dv together",
            "library": f"SDPA backward ({backend})"}
    rows["flash_bwd_dq_d32"] = dict(_timing_row(
        "flash_bwd_dq", shape, graph_ms(dq), plain, lib,
        6 * B * H * D * pairs,
        reads + 2 * B * H * S * D + 2 * B * H * S * D + 4 * B * H * S,
        errs[0][0]), timed_by="graph", eager_ms=eager_ms(dq, 50),
        library_eager_ms=lib_eager, max_rel_err=errs[0][1], **note)
    rows["flash_bwd_dkv_d32"] = dict(_timing_row(
        "flash_bwd_dkv", shape, graph_ms(dkv), plain, lib,
        8 * B * H * D * pairs,
        reads + 4 * B * H * S + 2 * 2 * B * Hkv * S * D,
        max(errs[1][0], errs[2][0])), timed_by="graph",
        eager_ms=eager_ms(dkv, 50), library_eager_ms=lib_eager,
        max_rel_err=max(errs[1][1], errs[2][1]), **note)
    del q, k, v, out, lse, dout, got, ref, sdpa_b
    Bp, Hp, Hkvp, (lo, hi), P = D32_PAGED
    lens = np.random.default_rng(21).integers(lo, hi + 1, size=Bp).tolist()
    qp, kv, bt, sl = _paged_inputs(Bp, Hp, Hkvp, D, PAGED_PAGE, lens,
                                   torch.bfloat16, seed=22, P=P)

    def dec():
        return paged.paged_decode(qp, kv, bt, sl, PAGED_PAGE)

    err = (dec().float() - paged._exact_path(qp, kv, bt, sl, PAGED_PAGE)
           .float()).abs().max().item()
    live = int(sum(lens))
    pages = sum(math.ceil(n / PAGED_PAGE) for n in lens)
    rows["paged_decode_d32"] = dict(_timing_row(
        "paged_decode", {"B": Bp, "H": Hp, "Hkv": Hkvp, "D": D,
                         "page": PAGED_PAGE, "P": P,
                         "seq_lens": [min(lens), max(lens)],
                         "dtype": "bfloat16"},
        graph_ms(dec), time_ms(lambda: paged._exact_path(
            qp, kv, bt, sl, PAGED_PAGE), 20), None, 4 * Hp * D * live,
        live * 2 * Hkvp * D * 2 + 2 * Bp * Hp * D * 2 + pages * 4 + Bp * 4,
        err), timed_by="graph", eager_ms=eager_ms(dec, 200),
        splits=paged._splits(qp.device, Bp, Hkvp, P),
        library="none (no one-call PyTorch equivalent)")
    torch.cuda.empty_cache()


def _timing_row(name, shape, ms, plain_ms, library_ms, flops, nbytes,
                err):
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return {"kernel": name, "shape": shape, "max_abs_err": err,
            "ms": ms, "timed_by": "eager", "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def _line_numbers(row):
    """A kernel_time row's numbers as the kernels line names them (the
    eager times too, where the row was timed by graph replay)."""
    keys = ("shape", "max_abs_err", "ms", "timed_by", "eager_ms",
            "plain_ms", "bound_ms", "bound_by", "library", "library_ms",
            "library_eager_ms", "splits", "cache_copies")
    return {k: row[k] for k in keys if k in row}


def phase_serve_exact():
    """Narrow fp32 model on the card: the engine's greedy streams through
    both kernels equal a per-token full forward with the plain attention."""
    import torch
    from ray_tpu_torch.llm import InferenceEngine, SamplingParams
    from ray_tpu_torch.models.llama import LlamaConfig, forward, init_params
    cfg = LlamaConfig(vocab_size=512, hidden=256, layers=2, heads=4,
                      kv_heads=2, head_dim=64, mlp_dim=512, max_seq_len=256,
                      dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, gen, device="cuda")
    ref_cfg = cfg.replace(attention_impl="reference")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 512, size=n).tolist() for n in (5, 17, 40, 64)]
    max_new = 12

    def gold(prompt):
        toks, out = list(prompt), []
        for _ in range(max_new):
            logits = forward(params, torch.tensor([toks], device="cuda"),
                             ref_cfg)
            nxt = int(logits[0, len(toks) - 1].argmax())
            out.append(nxt)
            toks.append(nxt)
        return out

    want = [gold(p) for p in prompts]
    opts = dict(device="cuda", max_slots=2, page_size=16, num_pages=64,
                prefill_buckets=(64,))
    eng = InferenceEngine(params, cfg, **opts)
    stepped = eng.generate(prompts, SamplingParams(max_tokens=max_new))
    eng = InferenceEngine(params, cfg, **opts)
    ids = [eng.add_request(p, SamplingParams(max_tokens=max_new))
           for p in prompts]
    done = {r.request_id: r.output_tokens for r in eng.run_pipelined(4)}
    pipelined = [done[i] for i in ids]
    emit({"phase": "serve_exact", "requests": len(prompts),
          "tokens_each": max_new, "step_equal": stepped == want,
          "pipelined_equal": pipelined == want})
    check(stepped == want, f"step() streams {stepped} != gold {want}")
    check(pipelined == want, f"run_pipelined streams {pipelined} != gold")


def phase_serve(smi):
    """llama_1b at full width and depth, served through the entry points a
    user calls: InferenceEngine.run_pipelined, then LLMServer from threads."""
    import torch
    from ray_tpu_torch.llm import InferenceEngine, LLMServer, SamplingParams
    from ray_tpu_torch.models.llama import init_params, llama_1b
    from ray_tpu_torch.ops.attention import flash_fwd
    from ray_tpu_torch.ops.paged_attention import paged_decode

    cfg = llama_1b()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, gen, param_dtype=torch.bfloat16,
                         device="cuda")
    n_req, prompt_len, max_new, page = 32, 256, 128, 16
    opts = dict(device="cuda", max_slots=32, page_size=page,
                prefill_buckets=(256,), record_token_times=True,
                num_pages=n_req * math.ceil((prompt_len + max_new + 1)
                                            / page) + 1)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, size=prompt_len).tolist()
               for _ in range(n_req)]
    eng = InferenceEngine(params, cfg, **opts)
    # Warm the libraries (cuBLAS handles, allocator) outside the timed run.
    eng.generate([prompts[0][:32]], SamplingParams(max_tokens=2))
    torch.cuda.synchronize()

    # -- the main path: launch counts read from this window only.
    flash_fwd.launches = 0
    paged_decode.launches = 0
    torch.cuda.reset_peak_memory_stats()
    for p in prompts:
        eng.add_request(p, SamplingParams(max_tokens=max_new))
    t0 = time.perf_counter()
    done = eng.run_pipelined(32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(len(done) == n_req and all(
        len(r.output_tokens) == max_new and r.finish_reason == "length"
        for r in done), "run_pipelined did not finish every request")

    server = LLMServer(lambda: (params, cfg), dict(opts, max_slots=8))
    try:
        bodies = [{"prompt_tokens": rng.integers(0, cfg.vocab_size,
                                                 size=n).tolist(),
                   "max_tokens": 32} for n in (600, 100, 256, 31)]
        results = [None] * len(bodies)

        def call(i):
            results[i] = server(bodies[i])

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(bodies))]
        for t in threads:
            t.start()
        stream_body = {"prompt_tokens": prompts[1][:64], "max_tokens": 24}
        streamed = list(server.stream(stream_body))
        for t in threads:
            t.join(timeout=300)
        check(not any(t.is_alive() for t in threads),
              "server calls did not return")
    finally:
        server.close()
    torch.cuda.synchronize()
    launches = {"flash_fwd": flash_fwd.launches,
                "paged_decode": paged_decode.launches}
    peak = torch.cuda.max_memory_allocated()
    # -- end of the main path.

    for body, res in zip(bodies, results):
        check(res is not None and len(res.get("output_tokens", ()))
              == body["max_tokens"] and res["finish_reason"] == "length",
              f"server call: {res}")
    toks = [it["token"] for it in streamed if "token" in it]
    check(len(toks) == stream_body["max_tokens"]
          and streamed[-1].get("finish_reason") == "length",
          f"stream: {streamed[-1]}")
    check(launches["flash_fwd"] > 0 and launches["paged_decode"] > 0,
          f"kernels not launched on the serving path: {launches}")

    ttft = [r.t_first - r.t_submit for r in done]
    itl = _token_gaps(done)
    decode_start = max(r.t_first for r in done)
    decode_tokens = sum(len(r.output_tokens) - 1 for r in done)
    tf = _teacher_forced(params, cfg, prompts[0], page)
    syncs = _chunk_syncs(params, cfg, prompts[2], page)
    prof = _profile_chunk(params, cfg, eng, page)
    emit({"phase": "serve", "model": "llama_1b", "card": smi,
          "requests": n_req + len(bodies) + 1,
          "pipelined": {"requests": n_req, "prompt_tokens": prompt_len,
                        "new_tokens": max_new, "wall_s": wall,
                        "gen_tok_s": n_req * max_new / wall,
                        "decode_tok_s": decode_tokens
                        / (t0 + wall - decode_start),
                        "ttft_s_p50": pct(ttft, 50),
                        "per_token_ms_p50": pct(itl, 50) * 1e3,
                        "per_token_ms_p99": pct(itl, 99) * 1e3,
                        "per_token_samples": len(itl)},
          "server": {"calls": len(bodies), "stream_tokens": len(toks),
                     "chunked_prompt_tokens": 600},
          "launches": launches, "peak_mem_gb": peak / 2**30,
          "teacher_forced": tf, "host_syncs_per_chunk": syncs,
          "decode_profile": prof})
    return launches


def _token_gaps(reqs):
    """Per-token latency samples after the first token: tokens that reach
    the host together (one decode chunk) share the gap since the previous
    delivery, split evenly among them."""
    gaps = []
    for r in reqs:
        times = r.token_times
        i = 1
        while i < len(times):
            j = i
            while j < len(times) and times[j] == times[i]:
                j += 1
            gaps += [(times[i] - times[i - 1]) / (j - i)] * (j - i)
            i = j
    return gaps


def _teacher_forced(params, cfg, prompt, page):
    """Kernel path vs plain path on the same tokens: one prefill, then 8
    decode steps fed the kernel path's greedy tokens."""
    import torch
    from ray_tpu_torch.llm import _model
    ref_cfg = cfg.replace(attention_impl="reference")
    toks = torch.tensor([prompt], device="cuda")
    n, steps = len(prompt), 8
    P = math.ceil((n + steps + 1) / page)
    bt = torch.arange(1, P + 1, dtype=torch.int32, device="cuda")[None]
    page_ids = bt[0].long()[torch.arange(n, device="cuda") // page]
    offs = torch.arange(n, device="cuda") % page
    state = {}
    errs = []
    for name, c in (("kernel", cfg), ("plain", ref_cfg)):
        logits, ks, vs = _model.prefill(params, toks, n, c)
        kv = tuple(torch.zeros((P + 1, page, 2 * cfg.kv_heads,
                                cfg.head_dim), dtype=cfg.dtype,
                               device="cuda") for _ in range(cfg.layers))
        state[name] = [logits, _model.write_prefill(kv, ks, vs, page_ids,
                                                    offs)]
    errs.append((state["kernel"][0] - state["plain"][0]).abs().max().item())
    tok = state["kernel"][0].argmax().view(1).to(torch.int32)
    active = torch.ones(1, dtype=torch.bool, device="cuda")
    for i in range(steps):
        pos = torch.tensor([n + i], dtype=torch.int32, device="cuda")
        out = {}
        for name, c in (("kernel", cfg), ("plain", ref_cfg)):
            out[name], state[name][1] = _model.decode_step(
                params, state[name][1], tok, pos, bt, active, c, page)
        errs.append((out["kernel"] - out["plain"]).abs().max().item())
        tok = out["kernel"].argmax(dim=-1).to(torch.int32)
    res = {"prefill_max_abs_err": errs[0],
           "decode_max_abs_err": max(errs[1:]), "tol": TOL_1B_LOGITS}
    check(max(errs) <= TOL_1B_LOGITS, f"llama_1b logits {res}")
    return res


def _chunk_syncs(params, cfg, prompt, page, temperature=0.0, top_k=0):
    """Host syncs that torch's sync debug mode reports during one decode
    chunk of 8 steps (greedy, or sampled at ``temperature``/``top_k``),
    and with its readback."""
    import torch
    from ray_tpu_torch.llm import _model
    n, steps = len(prompt), 8
    P = math.ceil((n + steps + 1) / page)
    kv = tuple(torch.zeros((P + 1, page, 2 * cfg.kv_heads, cfg.head_dim),
                           dtype=cfg.dtype, device="cuda")
               for _ in range(cfg.layers))
    bt = torch.arange(1, P + 1, dtype=torch.int32, device="cuda")[None]
    tok = torch.tensor([prompt[-1]], dtype=torch.int32, device="cuda")
    pos = torch.tensor([n], dtype=torch.int32, device="cuda")
    active = torch.ones(1, dtype=torch.bool, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out, _pos, _kv = _model.decode_chunk(
                params, kv, tok, pos, bt, active, gen, cfg, page, steps,
                temperature, top_k)
            inside = _syncs(caught)
            out.cpu()
            total = _syncs(caught)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    res = {"steps": steps, "temperature": temperature, "top_k": top_k,
           "inside_chunk": len(inside),
           "with_readback": len(total), "sites": sorted(set(total))}
    if inside:
        # Where the first one comes from: in "error" mode the sync raises
        # at its call site.
        torch.cuda.set_sync_debug_mode("error")
        try:
            _model.decode_chunk(params, kv, tok, pos, bt, active, gen, cfg,
                                page, steps, temperature, top_k)
        except RuntimeError as exc:
            res["first_sync_stack"] = [
                f"{os.path.basename(f.filename)}:{f.lineno}:{f.name}"
                for f in traceback.extract_tb(exc.__traceback__)][-6:]
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return res


def _syncs(caught):
    """Call sites of the synchronizing operations among recorded warnings:
    the sync debug mode's own message only (set_sync_debug_mode itself
    warns that it is experimental, which is no sync)."""
    return [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
            if "called a synchronizing CUDA operation" in str(w.message)]


def _profile_chunk(params, cfg, eng, page):
    """Where a decode chunk's time goes: 8 greedy steps over all 32 slots at
    a depth of ~320 tokens, timed on the host clock, then once under
    torch.profiler for device time by kernel."""
    import torch
    from ray_tpu_torch.llm import _model
    B, steps, depth = eng.max_slots, 8, 320
    P = math.ceil((depth + steps + 1) / page)
    bt = torch.arange(1, B * P + 1, dtype=torch.int32,
                      device="cuda").view(B, P)
    tok = torch.zeros(B, dtype=torch.int32, device="cuda")
    pos = torch.full((B,), depth, dtype=torch.int32, device="cuda")
    active = torch.ones(B, dtype=torch.bool, device="cuda")

    def run():
        out, _p, _kv = _model.decode_chunk(
            params, eng.kv_pages, tok, pos, bt, active, eng.generator, cfg,
            page, steps, 0.0, 0)
        return out.cpu()

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    wall = time.perf_counter() - t0
    busy_ms, top, _kinds = _device_time(run)
    idle = 1 - busy_ms / (wall * 1e3) if busy_ms else None
    check_share(idle, "serve decode chunk")
    return {"slots": B, "steps": steps, "depth": depth,
            "wall_ms_per_step": wall * 1e3 / steps,
            "device_busy_ms_per_step": busy_ms / steps,
            "device_idle_share": idle,
            "top_kernels_ms_per_step": [
                [name[:48], round(us / 1e3 / steps, 4), n // steps]
                for name, (us, n) in top]}


def _device_time(run, top: int = 8):
    """Device time of one call of ``run`` under torch.profiler: (busy ms,
    the ``top`` largest kernels as [(name, (us, launches))], device ms by
    kind of kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    by_kernel = {}
    for ev in prof.key_averages():
        # Kernel events only: an aten op's own entry repeats the device
        # time of the kernels it launched.
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0:
            by_kernel[ev.key] = (dev_us, ev.count)
    busy_ms = sum(us for us, _n in by_kernel.values()) / 1e3
    kinds = {}
    for name, (us, _n) in by_kernel.items():
        kind = _kernel_kind(name)
        kinds[kind] = kinds.get(kind, 0.0) + us / 1e3
    return (busy_ms, sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:top],
            dict(sorted(kinds.items(), key=lambda kv: -kv[1])))


def _kernel_kind(name: str) -> str:
    """The kind of a profiled kernel.  The port's own kernels are matched
    first, so a CUTLASS or CuTe name in their symbols files them under
    their own kind, never under the library's."""
    for kind, marks in (
            ("flash_fwd", ("flash_fwd_",)),
            ("flash_bwd_dq", ("flash_bwd_dq",)),
            ("flash_bwd_dkv", ("flash_bwd_dkv",)),
            ("flash_bwd (test-only check)", ("flash_bwd_",)),
            ("paged_decode", ("paged_decode",)),
            ("matmul (cuBLAS)", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
            ("optimizer (foreach)", ("multi_tensor", "foreach")),
            ("index / scatter", ("index", "scatter", "gather")),
            ("reduction", ("reduce_kernel", "softmax", "norm")),
            ("elementwise", ("elementwise", "vectorized", "copy"))):
        if any(m in name for m in marks):
            return kind
    return "other"


def phase_train_exact():
    """Narrow fp32 model on the card: three adamw steps of
    make_lm_train_step through the flash kernels equal three through the
    plain attention, from the same weights and batches."""
    import torch
    from ray_tpu_torch._tree import tree_leaves
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.ops.attention import (flash_bwd_dkv, flash_bwd_dq,
                                             flash_fwd)
    from ray_tpu_torch.parallel import build_mesh, make_lm_train_step
    cfg = LlamaConfig(vocab_size=512, hidden=256, layers=2, heads=4,
                      kv_heads=2, head_dim=64, mlp_dim=512, max_seq_len=256,
                      dtype=torch.float32, remat=True)
    rng = np.random.default_rng(5)
    batches = [{"tokens": rng.integers(0, 512, (4, 128)).astype(np.int32)}
               for _ in range(3)]
    mask = np.ones((4, 128), np.float32)
    mask[0, 40:] = 0.0
    batches[1]["loss_mask"] = mask
    runs = {}
    for impl in ("flash", "reference"):
        init_fn, step_fn, place = make_lm_train_step(
            cfg.replace(attention_impl=impl), build_mesh(),
            learning_rate=TRAIN_LR)
        params, opt = init_fn(torch.Generator(device="cuda").manual_seed(0))
        start = [t.detach().clone() for t in tree_leaves(params)]
        before = (flash_fwd.launches, flash_bwd_dq.launches,
                  flash_bwd_dkv.launches)
        metrics = []
        for b in batches:
            params, opt, m = step_fn(params, opt, place(b))
            metrics.append((m["loss"].item(), m["grad_norm"].item()))
        launched = [n - b for n, b in zip(
            (flash_fwd.launches, flash_bwd_dq.launches,
             flash_bwd_dkv.launches), before)]
        # What the three updates moved each leaf by (the step, not the
        # shared initial weights).
        moved = [t.detach() - s for t, s in zip(tree_leaves(params), start)]
        runs[impl] = (metrics, moved, launched)
    (km, kd, kl), (rm, rd, rl) = runs["flash"], runs["reference"]
    errs = {
        "loss": max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(km, rm)),
        "grad_norm": max(abs(a[1] - b[1]) / abs(b[1])
                         for a, b in zip(km, rm)),
        "params_moved": max((torch.linalg.vector_norm(a - b)
                             / torch.linalg.vector_norm(b)).item()
                            for a, b in zip(kd, rd))}
    elem = max(((a - b).abs().max() / b.abs().max()).item()
               for a, b in zip(kd, rd))
    res = {"phase": "train_exact", "steps": 3, "losses": [m[0] for m in km],
           "grad_norms": [m[1] for m in km], "max_rel_err": errs,
           "params_moved_max_elem_err_over_leaf_max": elem,
           "tol": TOL_TRAIN_EXACT,
           "launches": {"flash_fwd": kl[0], "flash_bwd_dq": kl[1],
                        "flash_bwd_dkv": kl[2], "reference_run": rl}}
    emit(res)
    check(kl == [3 * 2 * cfg.layers, 3 * cfg.layers, 3 * cfg.layers]
          and rl == [0, 0, 0], f"train_exact launches {res['launches']}")
    check(all(errs[k] <= TOL_TRAIN_EXACT[k] for k in errs),
          f"train_exact: kernel path vs plain path {errs}")


def phase_train(smi):
    """The JAX bench's training config at full width and depth through
    make_lm_train_step: 2 warm-up steps, then 5 timed steps on one repeated
    batch (the main path), then one profiled step and a kernel-vs-plain
    comparison at B=2."""
    import torch
    from ray_tpu_torch.models.llama import LlamaConfig, num_params
    from ray_tpu_torch.ops.attention import (flash_bwd_dkv, flash_bwd_dq,
                                             flash_fwd)
    from ray_tpu_torch.parallel import build_mesh, make_lm_train_step
    cfg = LlamaConfig(**TRAIN_CFG, dtype=torch.bfloat16, remat=True,
                      attention_impl="flash")
    init_fn, step_fn, place = make_lm_train_step(
        cfg, build_mesh(), learning_rate=TRAIN_LR,
        param_dtype=torch.bfloat16)
    params, opt = init_fn(torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    batch = place({"tokens": rng.integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ), dtype=np.int32)})
    losses = []
    for _ in range(2):          # warm-up: cuBLAS handles, allocator
        params, opt, m = step_fn(params, opt, batch)
        losses.append(m["loss"])
    torch.cuda.synchronize()

    # -- the main path: launch counts read from this window only.
    flash_fwd.launches = 0
    flash_bwd_dq.launches = 0
    flash_bwd_dkv.launches = 0
    torch.cuda.reset_peak_memory_stats()
    steps = 5
    t0 = time.perf_counter()
    for _ in range(steps):
        params, opt, m = step_fn(params, opt, batch)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_fwd": flash_fwd.launches,
                "flash_bwd_dq": flash_bwd_dq.launches,
                "flash_bwd_dkv": flash_bwd_dkv.launches}
    peak = torch.cuda.max_memory_allocated()
    # -- end of the main path.

    losses = [x.item() for x in losses]
    per_step = {k: n / steps for k, n in launches.items()}
    want = {"flash_fwd": 2 * cfg.layers, "flash_bwd_dq": cfg.layers,
            "flash_bwd_dkv": cfg.layers}
    check(per_step == want, f"launches per step {per_step} != {want}")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    step_s = wall / steps
    tok_s = TRAIN_BATCH * TRAIN_SEQ / step_s
    n_params = num_params(cfg)

    busy_ms, top, kinds = _device_time(lambda: step_fn(params, opt, batch),
                                       top=12)
    compare = _train_compare(cfg, params, rng)
    emit({"phase": "train", "config": "bench.py:3384-3390", "card": smi,
          "num_params": n_params, "batch": [TRAIN_BATCH, TRAIN_SEQ],
          "remat": True, "param_dtype": "bfloat16", "lr": TRAIN_LR,
          "steps_timed": steps, "step_ms": step_s * 1e3,
          "tokens_per_s": tok_s,
          "mfu": 6.0 * n_params * tok_s / PEAK_BF16_FLOPS,
          "peak_mem_gb": peak / 2**30, "losses": losses,
          "launches_per_step": per_step,
          "profile_one_step": {
              "device_busy_ms": busy_ms,
              "device_idle_share": 1 - busy_ms / (step_s * 1e3),
              "device_ms_by_kind": kinds,
              "top_kernels_ms": [[name[:48], round(us / 1e3, 3), n]
                                 for name, (us, n) in top]},
          "kernel_vs_plain_B2": compare})
    check_share(1 - busy_ms / (step_s * 1e3), "train")
    errs, tol = compare["rel_err"], TOL_TRAIN_BF16
    check(all(errs[k] <= tol[k] for k in tol),
          f"train B=2 kernel vs plain {compare}")
    check(all(e > tol["attn_grad"] for e, _ in
              compare["planted_faults_attn_grad"].values()),
          f"a planted backward fault passes the attention-gradient check: "
          f"{compare}")
    return launches, params, opt


ATTN_LEAVES = ("wq", "wk", "wv", "wo")
# Faults planted in flash_bwd's output for the B=2 comparison (dq, dk, dv
# scales): each must fail the attention-gradient check, which shows that the
# check can see a wrong backward.
PLANTED_FAULTS = {"dq zeroed": (0.0, 1.0, 1.0), "dq x0.9": (0.9, 1.0, 1.0),
                  "dk x0.9": (1.0, 0.9, 1.0), "dv x0.9": (1.0, 1.0, 0.9)}


def _loss_and_grads(cfg, params, batch):
    """One loss_fn forward and backward: (loss, global grad norm, the
    attention leaves' gradients [L, ...] by name)."""
    import torch
    from ray_tpu_torch._tree import tree_leaves
    from ray_tpu_torch.models.llama import loss_fn
    from ray_tpu_torch.optim import global_norm
    leaves = tree_leaves(params)
    loss = loss_fn(params, batch, cfg)
    grads = torch.autograd.grad(loss, leaves)
    at = {id(t): i for i, t in enumerate(leaves)}
    attn = {n: grads[at[id(params["blocks"][n])]] for n in ATTN_LEAVES}
    return loss.item(), global_norm(grads).item(), attn


def _worst_layer_err(got, ref):
    """The largest ||a - b|| / ||b|| over every layer of every attention
    leaf, and where it is."""
    import torch
    worst = (0.0, None)
    for n in ATTN_LEAVES:
        a, b = got[n].float().flatten(1), ref[n].float().flatten(1)
        per_layer = (torch.linalg.vector_norm(a - b, dim=1)
                     / torch.linalg.vector_norm(b, dim=1))
        i = int(per_layer.argmax())
        if per_layer[i].item() > worst[0]:
            worst = (per_layer[i].item(), f"{n}[{i}]")
    return worst


def _train_compare(cfg, params, rng):
    """At the same width and depth with B=2, from the same params: loss,
    global grad norm and the gradient of every layer's wq, wk, wv and wo,
    the flash kernels against attention_impl="reference".  Then the same
    with each planted fault in flash_bwd's output."""
    import importlib
    import torch
    # The module (ray_tpu_torch.ops re-exports its function `attention`).
    attn_mod = importlib.import_module("ray_tpu_torch.ops.attention")
    batch ={"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, TRAIN_SEQ), dtype=np.int32)).cuda()}
    kl, kg, kgrads = _loss_and_grads(cfg, params, batch)
    rl, rg, rgrads = _loss_and_grads(
        cfg.replace(attention_impl="reference"), params, batch)
    planted = {}
    real = attn_mod.flash_bwd
    for fault, scales in PLANTED_FAULTS.items():
        def faulty(*args, _scales=scales, **kw):
            return tuple(g * s for g, s in zip(real(*args, **kw), _scales))
        attn_mod.flash_bwd = faulty
        try:
            planted[fault] = _worst_layer_err(
                _loss_and_grads(cfg, params, batch)[2], rgrads)
        finally:
            attn_mod.flash_bwd = real
    worst, where = _worst_layer_err(kgrads, rgrads)
    return {"loss": [kl, rl], "grad_norm": [kg, rg],
            "rel_err": {"loss": abs(kl - rl) / abs(rl),
                        "grad_norm": abs(kg - rg) / abs(rg),
                        "attn_grad": worst},
            "attn_grad_worst_at": where,
            "planted_faults_attn_grad": planted, "tol": TOL_TRAIN_BF16}


# ---------------------------------------------------------------- this slice

def _launch_counts():
    from ray_tpu_torch.ops.attention import (flash_bwd_dkv, flash_bwd_dq,
                                             flash_fwd)
    from ray_tpu_torch.ops.paged_attention import paged_decode
    return {"flash_fwd": flash_fwd, "paged_decode": paged_decode,
            "flash_bwd_dq": flash_bwd_dq, "flash_bwd_dkv": flash_bwd_dkv}


def _reset_launches():
    for fn in _launch_counts().values():
        fn.launches = 0
        fn.launches_by_thread.clear()


def _read_launches():
    return {k: fn.launches for k, fn in _launch_counts().items()}


def _launches_by_thread():
    """{kernel: {thread name: launches}} since the last reset, for the
    kernels that launched."""
    return {k: dict(fn.launches_by_thread)
            for k, fn in _launch_counts().items() if fn.launches_by_thread}


def phase_serve_tiny():
    """The JAX preset llama_tiny (head_dim 32) served through LLMServer on
    the card: in fp32 the greedy streams equal a per-token full forward
    with the plain attention; in bf16 the kernel path's logits stay within
    TOL_1B_LOGITS of the plain path's, teacher-forced."""
    import torch
    from ray_tpu_torch.llm import LLMServer
    from ray_tpu_torch.models.llama import forward, init_params, llama_tiny
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, 512, size=n).tolist() for n in (5, 17, 40, 64)]
    max_new = 12
    out = {"phase": "serve_tiny", "model": "llama_tiny", "head_dim": 32}
    for dtype in (torch.float32, torch.bfloat16):
        cfg = llama_tiny().replace(dtype=dtype)
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
            0), param_dtype=dtype, device="cuda")
        opts = dict(device="cuda", max_slots=4, page_size=16, num_pages=64,
                    prefill_buckets=(64,))
        # -- the main path: launch counts read from this window only.
        _reset_launches()
        server = LLMServer(lambda: (params, cfg), opts)
        try:
            got = [server({"prompt_tokens": p, "max_tokens": max_new})
                   for p in prompts]
        finally:
            server.close()
        torch.cuda.synchronize()
        launches = _read_launches()
        # -- end of the main path.
        name = str(dtype).split(".")[-1]
        streams = [r["output_tokens"] for r in got]
        row = {"launches": launches, "requests": len(prompts)}
        if dtype == torch.float32:
            ref_cfg = cfg.replace(attention_impl="reference")

            def gold(prompt):
                toks, res = list(prompt), []
                for _ in range(max_new):
                    logits = forward(params, torch.tensor(
                        [toks], device="cuda"), ref_cfg)
                    res.append(int(logits[0, len(toks) - 1].argmax()))
                    toks.append(res[-1])
                return res

            row["greedy_equal"] = streams == [gold(p) for p in prompts]
            check(row["greedy_equal"], f"serve_tiny fp32 streams {streams}")
        else:
            row["teacher_forced"] = _teacher_forced(params, cfg, prompts[3],
                                                    16)
        check(all(len(t) == max_new for t in streams),
              f"serve_tiny {name}: {streams}")
        check(launches["flash_fwd"] > 0 and launches["paged_decode"] > 0,
              f"serve_tiny {name}: kernels not launched {launches}")
        out[name] = row
    emit(out)
    return {"flash_fwd": sum(out[n]["launches"]["flash_fwd"]
                             for n in ("float32", "bfloat16")),
            "paged_decode": sum(out[n]["launches"]["paged_decode"]
                                for n in ("float32", "bfloat16"))}


def phase_train_tiny():
    """One adamw step of llama_tiny (head_dim 32) and of bench.py's small
    config (bench.py:3392-3396: kv_heads 4, batch 4 x 256) through
    make_lm_train_step on the card: the D 32 kernels against the plain
    attention from the same weights.  fp32 within train_exact's
    tolerances; bf16 within the train phase's."""
    import torch
    from ray_tpu_torch._tree import tree_leaves
    from ray_tpu_torch.models.llama import llama_tiny
    from ray_tpu_torch.parallel import build_mesh, make_lm_train_step
    rng = np.random.default_rng(9)
    rows, total = [], {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    for name, base in (("llama_tiny", llama_tiny()),
                       ("bench_small", llama_tiny().replace(kv_heads=4))):
        for dtype in (torch.float32, torch.bfloat16):
            cfg = base.replace(dtype=dtype, remat=False)
            batch = {"tokens": rng.integers(0, 512, (4, 256)).astype(
                np.int32)}
            res = {}
            for impl in ("flash", "reference"):
                init_fn, step_fn, place = make_lm_train_step(
                    cfg.replace(attention_impl=impl), build_mesh(),
                    learning_rate=TRAIN_LR, param_dtype=dtype)
                params, opt = init_fn(torch.Generator(
                    device="cuda").manual_seed(0))
                start = [t.detach().clone() for t in tree_leaves(params)]
                # -- the main path (the flash run): counts from here.
                _reset_launches()
                params, opt, m = step_fn(params, opt, place(batch))
                torch.cuda.synchronize()
                launches = _read_launches()
                # -- end of the main path.
                moved = [t.detach().float() - s.float()
                         for t, s in zip(tree_leaves(params), start)]
                res[impl] = (m["loss"].item(), m["grad_norm"].item(), moved,
                             launches)
            (kl, kg, kd, kn), (rl, rg, rd, rn) = res["flash"], \
                res["reference"]
            errs = {"loss": abs(kl - rl) / abs(rl),
                    "grad_norm": abs(kg - rg) / abs(rg)}
            f32 = dtype == torch.float32
            if f32:
                errs["params_moved"] = max(
                    (torch.linalg.vector_norm(a - b)
                     / torch.linalg.vector_norm(b)).item()
                    for a, b in zip(kd, rd))
            tol = TOL_TRAIN_EXACT if f32 else TOL_TRAIN_BF16
            row = {"config": name, "dtype": str(dtype).split(".")[-1],
                   "loss": [kl, rl], "max_rel_err": errs,
                   "tol": {k: tol[k] for k in errs},
                   "launches": kn, "reference_run": rn}
            rows.append(row)
            check(all(errs[k] <= tol[k] for k in errs),
                  f"train_tiny {row}")
            want = {"flash_fwd": cfg.layers, "flash_bwd_dq": cfg.layers,
                    "flash_bwd_dkv": cfg.layers}
            check({k: kn[k] for k in want} == want
                  and not any(rn[k] for k in want),
                  f"train_tiny launches {row}")
            for k in total:
                total[k] += kn[k]
    emit({"phase": "train_tiny", "head_dim": 32, "steps": 1, "rows": rows})
    return total


def phase_serve_sampled(smi):
    """llama_1b as in serve, sampled at temperature 0.8 and top_k 40: no
    host sync inside a decode chunk; every generated token inside the
    top 40 of its step's logits (recomputed by a full forward through the
    kernels; a token counts as inside when its logit is within
    TOL_1B_LOGITS of the 40th, the logits' kernel-vs-plain tolerance); the
    same generator seed gives the same streams."""
    import torch
    from ray_tpu_torch.llm import InferenceEngine, SamplingParams
    from ray_tpu_torch.models.llama import forward, init_params, llama_1b
    cfg = llama_1b()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         param_dtype=torch.bfloat16, device="cuda")
    n_req, prompt_len, max_new, page, temp, top_k = 32, 256, 128, 16, 0.8, 40
    opts = dict(device="cuda", max_slots=32, page_size=page,
                prefill_buckets=(256,),
                num_pages=n_req * math.ceil((prompt_len + max_new + 1)
                                            / page) + 1)
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, cfg.vocab_size, size=prompt_len).tolist()
               for _ in range(n_req)]
    sp = SamplingParams(max_tokens=max_new, temperature=temp, top_k=top_k)
    runs, walls = [], []
    for _ in range(2):
        eng = InferenceEngine(params, cfg, generator=torch.Generator(
            device="cuda").manual_seed(123), **opts)
        ids = [eng.add_request(p, sp) for p in prompts]
        if not runs:
            # -- the main path: launch counts read from this window only.
            torch.cuda.synchronize()
            _reset_launches()
        t0 = time.perf_counter()
        done = {r.request_id: r.output_tokens for r in eng.run_pipelined(32)}
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if not runs:
            launches = _read_launches()
            # -- end of the main path.
        runs.append([done[i] for i in ids])
    check(runs[0] == runs[1], "serve_sampled: the same seed gave other "
          "streams")
    check(all(len(t) == max_new for t in runs[0]), "serve_sampled lengths")
    outside, worst = 0, math.inf
    for p, toks in zip(prompts[:4], runs[0][:4]):
        seq = torch.tensor([p + toks], device="cuda")
        with torch.no_grad():
            logits = forward(params, seq, cfg)[0, len(p) - 1:-1].float()
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1]
        mine = logits.gather(1, torch.tensor(toks, device="cuda")[:, None])
        margin = (mine[:, 0] - kth).min().item()
        worst = min(worst, margin)
        outside += int((mine[:, 0] < kth - TOL_1B_LOGITS).sum())
    syncs = _chunk_syncs(params, cfg, prompts[2], page, temp, top_k)
    greedy = _chunk_syncs(params, cfg, prompts[2], page)
    res = {"phase": "serve_sampled", "model": "llama_1b", "card": smi,
           "temperature": temp, "top_k": top_k, "requests": n_req,
           "new_tokens": max_new, "wall_s": walls,
           "gen_tok_s": [n_req * max_new / w for w in walls],
           "same_seed_same_streams": runs[0] == runs[1],
           "top_k_checked_tokens": 4 * max_new,
           "outside_top_k": outside, "least_margin_to_kth_logit": worst,
           "host_syncs_per_chunk": syncs, "greedy_host_syncs": greedy,
           "launches": launches}
    emit(res)
    check(outside == 0, f"serve_sampled: {outside} tokens outside the "
          f"top-{top_k}")
    check(syncs["inside_chunk"] == 0, f"serve_sampled syncs {syncs}")
    check(launches["flash_fwd"] > 0 and launches["paged_decode"] > 0,
          f"serve_sampled launches {launches}")
    return {k: launches[k] for k in ("flash_fwd", "paged_decode")}


def phase_paged_streams():
    """Two streams decoding different inputs at once (llama_1b's heads, a
    layout the split rule splits, so the workspace is used), each equal
    to the plain version; then a CUDA graph replayed on one stream beside
    eager calls on another, both right."""
    import torch
    from ray_tpu_torch.ops import paged_attention as paged
    rng = np.random.default_rng(11)
    ins = [_paged_inputs(4, 16, 8, 128, 16,
                         rng.integers(1000, 2049, size=4).tolist(),
                         torch.bfloat16, seed=600 + i, P=128)
           for i in range(2)]
    refs = [paged._exact_path(*x, 16) for x in ins]
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    for s in (s1, s2):
        s.wait_stream(torch.cuda.current_stream())
    # -- the main path: launch counts read from this window only.
    torch.cuda.synchronize()
    _reset_launches()
    outs = []
    for _ in range(50):
        for s, x in zip((s1, s2), ins):
            with torch.cuda.stream(s):
                outs.append(paged.paged_decode(*x, 16))
    torch.cuda.synchronize()
    eager_launches = paged.paged_decode.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=s1):
        g_out = paged.paged_decode(*ins[0], 16)
    s2.wait_stream(torch.cuda.current_stream())
    beside = []
    for _ in range(20):
        with torch.cuda.stream(s1):       # the capture stream's workspace
            graph.replay()
        with torch.cuda.stream(s2):
            beside.append(paged.paged_decode(*ins[1], 16))
    torch.cuda.synchronize()
    launches = _read_launches()
    # -- end of the main path.
    worst = {"max_abs_err": 0.0, "row_rel_err": 0.0}
    for i, out in enumerate(outs + [g_out] + beside):
        j = i % 2 if i < len(outs) else (0 if i == len(outs) else 1)
        live = ins[j][3] > 0
        worst["max_abs_err"] = max(worst["max_abs_err"], (
            out[live].float() - refs[j][live].float()).abs().max().item())
        worst["row_rel_err"] = max(worst["row_rel_err"], row_rel_err(
            out[live], refs[j][live]))
    ws = {s.cuda_stream: paged._WORKSPACE[(ins[0][0].device,
                                           s.cuda_stream)][0].data_ptr()
          for s in (s1, s2)}
    res = {"phase": "paged_streams", "eager_calls_each_stream": 50,
           "graph_replays_beside_eager": 20, "errors": worst,
           "tol": TOL["bfloat16"], "tol_row_rel": TOL_PAGED_ROW_REL[
               "bfloat16"], "workspaces_distinct": len(set(ws.values())) == 2,
           "splits": paged._splits(ins[0][0].device, 4, 8, 128),
           "launches": launches, "eager_launches": eager_launches}
    emit(res)
    check(res["workspaces_distinct"], f"paged_streams workspaces {ws}")
    check(worst["max_abs_err"] <= TOL["bfloat16"]
          and worst["row_rel_err"] <= TOL_PAGED_ROW_REL["bfloat16"],
          f"paged_streams {worst}")
    check(eager_launches == 100, f"paged_streams launches {launches}")
    return {"paged_decode": launches["paged_decode"]}


# ---------------------------------------------------- disaggregated serving

#: llama_1b's serving engine in the disagg and fleet phases: 32 slots, 16-
#: token pages, the JAX engine's buckets, 2,048 pages (1 MiB a page at
#: llama_1b's width: 16 layers x 16 tokens x 16 combined heads x 128 x 2 B).
SERVE_OPTS = dict(device="cuda", max_slots=32, page_size=16,
                  prefill_buckets=(64, 256, 1024), num_pages=2048)
#: Poisson arrivals at 8 req/s for 8 s, a quarter long: about 40% of what a
#: 32-slot batch finishes at PERF.md's 23.4 ms a step (NVIDIA H100 80GB
#: HBM3, 700.00 W).
LOAD_SPEC = dict(rps=8.0, duration_s=8.0, long_fraction=0.25,
                 short_prompt=32, short_max_tokens=64, long_prompt=960,
                 long_max_tokens=16, drain_timeout_s=120.0)
#: The saturation run: chunked at 4x the offered rate for 3 s under tight
#: class bounds (bench.py:2217-2226).
SAT_RPS, SAT_DURATION_S, SAT_DEADLINE_S = 32.0, 3.0, 2.0
#: Admitted TTFT p99 must stay under this at saturation (the JAX tier-1
#: smoke's bound, tests/test_llm_disagg.py).
SAT_TTFT_P99_MS = 5000.0
#: The fleet's prefix-heavy traffic (bench.py:2253-2264): 8 prompts of 960
#: tokens, 4 new tokens each, at 40 req/s for 5 s; each replica's cache
#: holds half the pool in real handoff bytes.
FLEET_POOL, FLEET_RPS, FLEET_DURATION_S = 8, 40.0, 5.0
#: The unsaturated hit-vs-cold TTFT split: 6 req/s for 3 s on one replica.
FLEET_LIGHT_RPS, FLEET_LIGHT_S = 6.0, 3.0
FLEET_PROMPT, FLEET_MAX_TOKENS = 960, 4


def _open_admission():
    """Admit everything: the equal-load runs compare latency at the same
    admitted load, not shedding (bench.py's ``open_adm``)."""
    from ray_tpu_torch.llm.disagg import AdmissionConfig, RequestClass
    return AdmissionConfig(classes={"default": RequestClass(
        max_queue_depth=100000, queue_deadline_s=600.0)})


def _load_row(r):
    """The numbers a run of ``run_open_loop`` reports, as recorded."""
    keys = ("offered", "offered_rps", "completed", "sustained_rps",
            "shed_submit", "shed_deadline", "shed_rate", "errors",
            "rejected", "unfinished", "ttft_p50_ms", "ttft_p99_ms",
            "itl_p50_ms", "itl_p99_ms", "itl_samples", "prefix_hits",
            "prefix_hit_rate", "ttft_hit_p50_ms", "ttft_cold_p50_ms")
    return {k: r[k] for k in keys}


def phase_disagg_exact():
    """The narrow fp32 model of serve_exact on the card: greedy streams
    equal a per-token full forward with the plain attention through
    DisaggServer in each mode, FleetServer with 1 and 2 replicas, a full
    prefix hit replayed from a replica's cache, and a handoff made by the
    PrefillWorker imported into a fresh engine.  A sampled request of a
    cached prompt is never replayed."""
    import torch
    from ray_tpu_torch.llm import InferenceEngine, SamplingParams
    from ray_tpu_torch.llm.disagg import DisaggServer, PrefillWorker
    from ray_tpu_torch.llm.fleet import FleetConfig, FleetServer
    from ray_tpu_torch.models.llama import LlamaConfig, forward, init_params
    cfg = LlamaConfig(vocab_size=512, hidden=256, layers=2, heads=4,
                      kv_heads=2, head_dim=64, mlp_dim=512, max_seq_len=256,
                      dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    ref_cfg = cfg.replace(attention_impl="reference")
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, 512, size=n).tolist() for n in (5, 17, 40, 64)]
    max_new = 12

    def gold(prompt):
        toks, out = list(prompt), []
        for _ in range(max_new):
            logits = forward(params, torch.tensor([toks], device="cuda"),
                             ref_cfg)
            out.append(int(logits[0, len(toks) - 1].argmax()))
            toks.append(out[-1])
        return out

    t0 = time.perf_counter()
    want = [gold(p) for p in prompts]
    opts = dict(device="cuda", max_slots=2, page_size=16, num_pages=64,
                prefill_buckets=(64,))

    def body(prompt):
        return {"prompt_tokens": prompt, "max_tokens": max_new,
                "timeout_s": 120}

    res = {"phase": "disagg_exact", "requests_each": len(prompts),
           "tokens_each": max_new,
           "seconds": {"gold": time.perf_counter() - t0}}

    def lap(name):
        res["seconds"][name] = time.perf_counter() - t0 - sum(
            res["seconds"].values())

    _reset_launches()
    for mode in ("inline", "chunked", "disagg"):
        eo = dict(opts, prefill_chunk=16) if mode == "chunked" else opts
        srv = DisaggServer(lambda: (params, cfg), mode=mode,
                           engine_options=eo)
        try:
            pubs = [srv.submit(body(p)) for p in prompts]
            got = [srv.result(x, timeout_s=120) for x in pubs]
        finally:
            srv.close()
        res[mode] = [g.get("output_tokens") for g in got] == want
        lap(mode)
        check(res[mode], f"disagg_exact {mode}: {got} != gold {want}")
    for n in (1, 2):
        srv = FleetServer(lambda: (params, cfg), name=f"exact{n}",
                          config=FleetConfig(num_replicas=n,
                                             engine_options=opts,
                                             cache_capacity_bytes=1 << 26))
        try:
            pubs = [srv.submit(body(p)) for p in prompts]
            got = [srv.result(x, timeout_s=120) for x in pubs]
            res[f"fleet_{n}"] = [g.get("output_tokens") for g in got] == want
            check(res[f"fleet_{n}"],
                  f"disagg_exact fleet x{n}: {got} != gold {want}")
            if n == 1:
                hit = srv(body(prompts[2]))
                sampled = srv(dict(body(prompts[2]), temperature=0.8,
                                   top_k=40))
                res["full_hit_replayed"] = (
                    hit.get("prefix_outcome") == "full"
                    and hit.get("output_tokens") == want[2])
                res["sampled_outcome"] = sampled.get("prefix_outcome")
                check(res["full_hit_replayed"], f"disagg_exact hit {hit}")
                check(sampled.get("prefix_outcome") != "full"
                      and len(sampled.get("output_tokens", ())) == max_new,
                      f"disagg_exact: a sampled request replayed {sampled}")
        finally:
            srv.close()
        lap(f"fleet_{n}")
    pw = PrefillWorker(params, cfg, device="cuda", prefill_buckets=(64,),
                       page_size=16)
    eng = InferenceEngine(params, cfg, **opts)
    rid = eng.import_prefill(pw.prefill(prompts[3],
                                        SamplingParams(max_tokens=max_new)))
    done = {}
    while eng.has_work():
        for r in eng.step():
            done[r.request_id] = r.output_tokens
    res["handoff_round_trip"] = done.get(rid) == want[3]
    check(res["handoff_round_trip"],
          f"disagg_exact round trip {done.get(rid)} != {want[3]}")
    torch.cuda.synchronize()
    res["launches"] = _read_launches()
    res["launches_by_thread"] = _launches_by_thread()
    emit(res)
    check(res["launches"]["flash_fwd"] > 0
          and res["launches"]["paged_decode"] > 0,
          f"disagg_exact launches {res['launches']}")


def _import_device_ms(eng, handoff, reps: int = 5) -> float:
    """Least device time of one ``import_prefill`` scatter of ``handoff``
    on the engine's stream (CUDA events around it; the request is
    cancelled after each so its pages come back)."""
    import torch
    best = None
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(eng.stream)
        rid = eng.import_prefill(handoff)
        end.record(eng.stream)
        end.synchronize()
        check(rid is not None, "import_prefill found no room")
        eng.cancel(rid)
        ms = start.elapsed_time(end)
        best = ms if best is None else min(best, ms)
    return best


def phase_serving_tiers(smi):
    """disagg_load, then fleet, then lock_profile, on one set of llama_1b
    weights (bf16, from a seeded generator, as the serve phase's)."""
    import torch
    from ray_tpu_torch.models.llama import init_params, llama_1b
    cfg = llama_1b()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         param_dtype=torch.bfloat16, device="cuda")
    disagg = phase_disagg_load(smi, params, cfg)
    torch.cuda.empty_cache()
    fleet = phase_fleet(smi, params, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    lock_profile = phase_lock_profile(smi, params, cfg)
    # Servers, replicas and their threads refer to each other: collect
    # them now, so their pages are free for the phases after.
    gc.collect()
    return disagg, fleet, lock_profile


def phase_disagg_load(smi, params, cfg):
    """llama_1b at full width (bf16, seeded weights) behind DisaggServer
    under open-loop Poisson traffic (LOAD_SPEC) in each mode, then chunked
    at saturation under tight class bounds.  Each run's launch counts are
    zeroed just before it and read just after, by thread: in disagg mode
    the flash forward runs in the dispatcher's thread (the prefill
    worker's, on its own stream) and the paged decode in the engine's."""
    import torch
    from ray_tpu_torch.llm.disagg import (AdmissionConfig, DisaggServer,
                                          RequestClass, ServeLoadSpec,
                                          run_open_loop)
    out = {"phase": "disagg_load", "model": "llama_1b", "card": smi,
           "engine": {k: v for k, v in SERVE_OPTS.items() if k != "device"},
           "traffic": LOAD_SPEC}
    totals = {"flash_fwd": 0, "paged_decode": 0}

    def run(mode, admission, spec, chunk=None):
        eo = dict(SERVE_OPTS)
        if chunk is not None:
            eo["prefill_chunk"] = chunk
        srv = DisaggServer(lambda: (params, cfg), mode=mode,
                           admission=admission, engine_options=eo,
                           record_token_times=True)
        imports = []
        try:
            for n in (LOAD_SPEC["short_prompt"], LOAD_SPEC["long_prompt"]):
                srv({"prompt_tokens": list(range(1, n + 1)),
                     "max_tokens": 2, "timeout_s": 300})
            if mode == "disagg":
                inner = srv.engine.import_prefill

                def timed(handoff):
                    t0 = time.perf_counter()
                    rid = inner(handoff)
                    if rid is not None:
                        imports.append(((time.perf_counter() - t0) * 1e3,
                                        handoff.nbytes))
                    return rid
                srv.engine.import_prefill = timed
            torch.cuda.synchronize()
            # -- the main path: launch counts read from this window only.
            _reset_launches()
            r = run_open_loop(srv, spec, vocab_size=cfg.vocab_size)
            torch.cuda.synchronize()
            launches = _read_launches()
            by_thread = _launches_by_thread()
            # -- end of the main path.
            row = _load_row(r)
            if mode == "disagg":
                # The class's method again (the wrapper held the engine in
                # a reference cycle, kept alive until a garbage collection).
                del srv.engine.import_prefill
                probe = srv.prefill_worker.prefill(
                    list(range(1, LOAD_SPEC["long_prompt"] + 1)))
                row["import_device_ms_960"] = _import_device_ms(srv.engine,
                                                                probe)
                row["handoff_bytes_960"] = probe.nbytes
        finally:
            srv.close()
        for k in totals:
            totals[k] += launches[k]
        row["launches"] = {k: launches[k] for k in totals}
        row["launches_by_thread"] = by_thread
        if imports:
            ms = [m for m, _b in imports]
            row["imports"] = len(imports)
            row["handoff_bytes_mean"] = float(np.mean([b for _m, b in
                                                       imports]))
            row["import_host_ms_p50"] = pct(ms, 50)
            row["import_host_ms_max"] = max(ms)
        check(r["unfinished"] == 0 and r["errors"] == 0 and r["completed"],
              f"disagg_load {mode}: {row}")
        drive = "disagg-drive"
        prefill_thread = "disagg-dispatch" if mode == "disagg" else drive
        check(by_thread.get("flash_fwd", {}).get(prefill_thread, 0) > 0
              and by_thread.get("paged_decode", {}).get(drive, 0) > 0,
              f"disagg_load {mode}: launches by thread {by_thread}")
        return row

    t0 = time.perf_counter()
    for mode in ("inline", "chunked", "disagg"):
        out[mode] = run(mode, _open_admission(), ServeLoadSpec(**LOAD_SPEC),
                        chunk=256 if mode == "chunked" else None)
        emit({"phase": "disagg_load", "mode": mode, **out[mode]})
    slots = SERVE_OPTS["max_slots"]
    tight = AdmissionConfig(classes={
        "interactive": RequestClass("interactive", token_budget=4096,
                                    max_queue_depth=2 * slots,
                                    queue_deadline_s=SAT_DEADLINE_S),
        "batch": RequestClass("batch", token_budget=4096,
                              max_queue_depth=slots,
                              queue_deadline_s=SAT_DEADLINE_S),
        "default": RequestClass()})
    sat = run("chunked", tight, ServeLoadSpec(
        **dict(LOAD_SPEC, rps=SAT_RPS, duration_s=SAT_DURATION_S)),
        chunk=256)
    out["saturation"] = dict(sat, rps=SAT_RPS, duration_s=SAT_DURATION_S)
    inline_itl = out["inline"]["itl_p99_ms"]
    best = min(x for x in (out["chunked"]["itl_p99_ms"],
                           out["disagg"]["itl_p99_ms"]) if x is not None)
    # JAX's bench contract (chunked or disagg ITL p99 at least 2x better
    # than inline) is reported, not enforced.
    out["itl_p99_improvement_x"] = inline_itl / best if best else None
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = totals
    emit({k: v for k, v in out.items()
          if k not in ("inline", "chunked", "disagg")})
    check(sat["shed_submit"] + sat["shed_deadline"] > 0,
          f"disagg_load saturation shed nothing: {sat}")
    check(sat["ttft_p99_ms"] is not None
          and sat["ttft_p99_ms"] < SAT_TTFT_P99_MS,
          f"disagg_load saturation TTFT p99 {sat['ttft_p99_ms']}")
    return totals


def phase_fleet(smi, params, cfg):
    """llama_1b (bf16) behind FleetServer on one card: prefix-heavy traffic
    on 1 and on 2 replicas (each replica's cache holds half the pool), an
    unsaturated hit-vs-cold TTFT split, a replica killed in flight (its
    requests shed retriably as replica_lost while the fleet backfills),
    and an autoscale up and back down.  Launch counts by thread: the
    flash forward in the dispatcher's (the prefill tier's) thread, the
    paged decode in every replica's drive thread."""
    import torch
    from ray_tpu_torch.llm import SamplingParams
    from ray_tpu_torch.llm.disagg import (PrefillWorker, ServeLoadSpec,
                                          run_open_loop)
    from ray_tpu_torch.llm.fleet import FleetConfig, FleetServer
    eo = dict(SERVE_OPTS)
    out = {"phase": "fleet", "model": "llama_1b", "card": smi,
           "pool": FLEET_POOL, "rps": FLEET_RPS,
           "duration_s": FLEET_DURATION_S}
    t0 = time.perf_counter()
    entry = PrefillWorker(params, cfg, device="cuda",
                          prefill_buckets=eo["prefill_buckets"],
                          page_size=eo["page_size"]).prefill(
        list(range(1, FLEET_PROMPT + 1)),
        SamplingParams(max_tokens=FLEET_MAX_TOKENS)).nbytes
    cache_bytes = int(entry * (FLEET_POOL // 2) + entry // 2)
    FLEET_CACHE["bytes"] = cache_bytes
    out.update(entry_bytes=entry, cache_capacity_bytes=cache_bytes)
    spec = dict(rps=FLEET_RPS, duration_s=FLEET_DURATION_S,
                long_fraction=1.0, long_prompt=FLEET_PROMPT,
                long_max_tokens=FLEET_MAX_TOKENS, short_prompt=32,
                short_max_tokens=FLEET_MAX_TOKENS, prompt_pool=FLEET_POOL,
                drain_timeout_s=120.0)
    totals = {"flash_fwd": 0, "paged_decode": 0}
    adm = _open_admission()
    for n in (1, 2):
        name = f"fleet{n}"
        srv = FleetServer(lambda: (params, cfg), name=name, admission=adm,
                          config=FleetConfig(num_replicas=n,
                                             engine_options=eo,
                                             cache_capacity_bytes=cache_bytes),
                          record_token_times=True)
        try:
            # Every replica takes a request off the clock (constant
            # prompts: no prefix hits against the measured pool).
            pubs = [srv.submit({"prompt_tokens": [1] * (FLEET_PROMPT - i),
                                "max_tokens": 2, "timeout_s": 300})
                    for i in range(2 * n)]
            for x in pubs:
                srv.result(x, timeout_s=300)
            if n == 1:
                split = run_open_loop(srv, ServeLoadSpec(**dict(
                    spec, rps=FLEET_LIGHT_RPS, duration_s=FLEET_LIGHT_S,
                    seed=7)), cfg.vocab_size)
                out["ttft_split"] = _load_row(split)
            waits = _time_router_calls(srv)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            # -- the main path: launch counts read from this window only.
            _reset_launches()
            r = run_open_loop(srv, ServeLoadSpec(**spec), cfg.vocab_size)
            torch.cuda.synchronize()
            launches = _read_launches()
            by_thread = _launches_by_thread()
            # -- end of the main path.
            _untime_router_calls(srv, waits)
            replicas = [rep.name for rep in srv._replicas.values()]
            st = srv.status()
        finally:
            srv.close()
        row = _load_row(r)
        row.update(launches=launches, launches_by_thread=by_thread,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
                   prefix=st["prefix"], rebalances=st["rebalances"],
                   router_calls=_summarize_waits(waits))
        for k in totals:
            totals[k] += launches[k]
        out[f"replicas_{n}"] = row
        FLEET_IN_PROCESS[n] = row
        emit({"phase": "fleet", "replicas": n, **row})
        check(r["unfinished"] == 0 and r["errors"] == 0,
              f"fleet x{n}: {row}")
        check(by_thread.get("flash_fwd", {}).get(f"fleet-dispatch-{name}",
                                                 0) > 0
              and all(by_thread.get("paged_decode", {}).get(
                  f"fleet-decode-{rep}", 0) > 0 for rep in replicas),
              f"fleet x{n}: launches by thread {by_thread} (replicas "
              f"{replicas})")
    f1, f2 = out["replicas_1"], out["replicas_2"]
    out["scaling_2x"] = f2["sustained_rps"] / f1["sustained_rps"]
    split = out["ttft_split"]
    out["hit_ttft_ratio"] = (split["ttft_hit_p50_ms"]
                             / split["ttft_cold_p50_ms"]) \
        if split["ttft_hit_p50_ms"] and split["ttft_cold_p50_ms"] else None
    check(f2["prefix_hits"] > 0, f"fleet x2: no prefix hit {f2}")
    out["kill"] = _fleet_kill(params, cfg, eo)
    out["autoscale"] = _fleet_autoscale(params, cfg, eo)
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = totals
    emit({k: v for k, v in out.items()
          if k not in ("replicas_1", "replicas_2")})
    return totals


#: phase_fleet's rows by replica count, reported beside fleet_remote's.
FLEET_IN_PROCESS = {}


def _time_router_calls(srv):
    """Time, on the host clock, every call the router and the load
    generator make into a replica's engine (``load_stats`` for routing and
    admission, ``import_prefill`` for a handoff or a replay): each takes
    the engine's lock, which the drive thread holds through a whole decode
    step.  Returns {call: [ms, ...]}, filled as the run goes."""
    waits = {"load_stats": [], "import_prefill": []}
    for rep in srv._replicas.values():
        for name, ms in waits.items():
            inner = getattr(rep.engine, name)

            def timed(*a, _inner=inner, _ms=ms, **k):
                t0 = time.perf_counter()
                try:
                    return _inner(*a, **k)
                finally:
                    _ms.append((time.perf_counter() - t0) * 1e3)
            setattr(rep.engine, name, timed)
    return waits


def _untime_router_calls(srv, waits):
    """Undo ``_time_router_calls``: each engine's own methods again (a
    wrapper holds its engine in a reference cycle, which would keep the
    engine's pages allocated until a garbage collection)."""
    for rep in srv._replicas.values():
        for name in waits:
            rep.engine.__dict__.pop(name, None)


def _summarize_waits(waits):
    return {name: {"calls": len(ms), "ms_p50": pct(ms, 50) if ms else None,
                   "ms_p99": pct(ms, 99) if ms else None,
                   "ms_total": float(sum(ms))}
            for name, ms in waits.items()}


def _fleet_kill(params, cfg, eo):
    """Two replicas; one killed while it holds mapped requests: those shed
    retriably as replica_lost, the rest finish, and the manager backfills
    to two replicas, which serve again."""
    from ray_tpu_torch.llm.fleet import FleetConfig, FleetServer
    srv = FleetServer(lambda: (params, cfg), name="chaos",
                      admission=_open_admission(),
                      config=FleetConfig(num_replicas=2, engine_options=eo,
                                         manager_interval_s=0.1))
    rng = np.random.default_rng(21)
    try:
        pubs = [srv.submit({"prompt_tokens": rng.integers(
            0, cfg.vocab_size, 32).tolist(), "max_tokens": 50,
            "timeout_s": 300}) for _ in range(16)]
        deadline = time.perf_counter() + 60
        victim = None
        while victim is None and time.perf_counter() < deadline:
            with srv._lock:
                victim = next((name for name, _rid in srv._rid_map
                               if name in srv._replicas), None)
            time.sleep(0.01)
        check(victim is not None, "fleet kill: no mapped request")
        t_kill = time.perf_counter()
        check(srv.kill_replica(victim), f"fleet kill: {victim} not killed")
        while time.perf_counter() < deadline:
            st = srv.status()
            if len(st["replicas"]) == 2 and not st["draining"]:
                break
            time.sleep(0.01)
        backfill_s = time.perf_counter() - t_kill
        results = [srv.result(x, timeout_s=300) for x in pubs]
        after = srv({"prompt_tokens": [9, 8, 7], "max_tokens": 3,
                     "timeout_s": 120})
        st = srv.status()
    finally:
        srv.close()
    shed = [r for r in results if r.get("finish_reason") == "shed"]
    done = [r for r in results if r.get("finish_reason") == "length"]
    row = {"requests": len(results), "shed": len(shed),
           "replica_lost": sum(r.get("reason") == "replica_lost"
                               for r in shed),
           "finished": len(done), "replicas_after": len(st["replicas"]),
           "backfill_s": backfill_s, "served_after": "error" not in after}
    check(row["replica_lost"] > 0 and all(r.get("retriable") for r in shed)
          and len(shed) + len(done) == len(results)
          and row["replicas_after"] == 2 and row["served_after"],
          f"fleet kill: {row}")
    return row


def _fleet_autoscale(params, cfg, eo):
    """One replica of one slot under a burst at three times its measured
    sequential rate: the manager scales up; once the burst is served the
    idle fleet drains back down to one replica, and nothing is left
    unfinished (bench.py's autoscale run)."""
    from ray_tpu_torch.llm.disagg import ServeLoadSpec, run_open_loop
    from ray_tpu_torch.llm.fleet import (FleetConfig, FleetServer,
                                         ServeScaleConfig)
    scale = ServeScaleConfig(min_replicas=1, max_replicas=2, queue_high=2.0,
                             sustain_s=0.5, down_sustain_s=1.5,
                             cooldown_s=1.0, window_s=2.0)
    srv = FleetServer(lambda: (params, cfg), name="auto",
                      admission=_open_admission(),
                      config=FleetConfig(num_replicas=1,
                                         engine_options=dict(eo,
                                                             max_slots=1),
                                         autoscale=scale,
                                         manager_interval_s=0.1),
                      record_token_times=True)
    max_tokens = 8
    try:
        for i in range(2):
            srv({"prompt_tokens": [2 + i] * 32, "max_tokens": max_tokens,
                 "timeout_s": 300})
        t0 = time.perf_counter()
        for i in range(3):
            srv({"prompt_tokens": [9 + i] * 32, "max_tokens": max_tokens,
                 "timeout_s": 300})
        t_seq = (time.perf_counter() - t0) / 3
        burst_rps = min(400.0, max(10.0, 3.0 / t_seq))
        burst = run_open_loop(srv, ServeLoadSpec(
            rps=burst_rps, duration_s=1.0, long_fraction=0.0,
            short_prompt=32, short_max_tokens=max_tokens,
            drain_timeout_s=120.0), cfg.vocab_size)
        after_burst = srv.status()
        deadline = time.perf_counter() + 30.0
        while time.perf_counter() < deadline:
            st = srv.status()
            if st["scales"].get("down", 0) >= 1 \
                    and len(st["replicas"]) <= 1 and not st["draining"]:
                break
            time.sleep(0.1)
    finally:
        srv.close()
    row = {"t_seq_ms": t_seq * 1e3, "burst_rps": burst_rps,
           "burst": _load_row(burst),
           "scales_after_burst": after_burst["scales"],
           "scales": st["scales"], "final_replicas": len(st["replicas"])}
    check(st["scales"].get("up", 0) >= 1 and st["scales"].get("down", 0) >= 1
          and row["final_replicas"] == 1 and burst["unfinished"] == 0
          and burst["errors"] == 0, f"fleet autoscale: {row}")
    return row


# ------------------------------------------------------------ data_train

# The token corpus of data_train: raw int32 shards, as LLM pre-training
# corpora are kept, of rows of TRAIN_SEQ + 1 tokens (the inputs and their
# next-token targets) over the 1.36B config's vocab, from a seed.
DATA_SHARDS, DATA_ROWS, DATA_MIN_ROWS = 8, 512, 96
DATA_ROW = TRAIN_SEQ + 1
DATA_WORKERS, DATA_STEPS = 4, 4
# Copies of the corpus in /dev/shm at the shuffle's peak: the map side's
# parts, the merged blocks, and the blocks the driver holds mapped.
DATA_SHM_COPIES = 3


def tokens_to_rows(row_len, batch):
    """data_train's ``map_batches`` body: each file of raw int32 tokens
    (a ``read_binary_files`` row) cut into rows of ``row_len`` tokens.  At
    the top level of the module: task workers import it by reference."""
    return {"tokens": np.concatenate([
        np.frombuffer(b, np.int32).reshape(-1, row_len)
        for b in batch["bytes"]])}


def write_token_corpus(root, shards, rows, row_len, vocab, seed):
    """``shards`` files of ``rows`` x ``row_len`` int32 tokens under
    ``root``; returns every row, in file order."""
    rng = np.random.default_rng(seed)
    parts = []
    for i in range(shards):
        toks = rng.integers(0, vocab, (rows, row_len), dtype=np.int32)
        toks.tofile(os.path.join(root, f"shard-{i:03d}.bin"))
        parts.append(toks)
    return np.concatenate(parts)


def token_pipeline(root, row_len, seed=0):
    """read tasks -> rows of ``row_len`` tokens -> the two-stage shuffle."""
    import functools
    from ray_tpu_torch import data as rdata
    return (rdata.read_binary_files(root)
            .map_batches(functools.partial(tokens_to_rows, row_len))
            .random_shuffle(seed=seed))


def _row_multiset(rows):
    """Rows as one sorted array of byte strings: equal iff the two row
    multisets are."""
    a = np.ascontiguousarray(rows)
    return np.sort(a.view(np.dtype((np.void, a.shape[1] * a.itemsize)))
                   .ravel())


def _split_rows(t):
    """A (B, S + 1) token tensor as the step's batch: S inputs, their
    next tokens as targets, every position counted."""
    import torch
    tokens = t[:, :-1].contiguous()
    return {"tokens": tokens, "targets": t[:, 1:].contiguous(),
            "loss_mask": torch.ones_like(tokens)}


class _StepMarks:
    """CUDA events around each step of a window, in stream order: the
    device is idle between one step's last kernel and the next step's
    first (waiting on the host: the batch, its copy).
    ``idle_between_steps()`` is that time over the window from the first
    step's start to the last one's end; idle time inside a step is not
    counted, so it is not the profiler's whole-window idle share of the
    other phases.  (``torch.profiler`` windows over these steps read
    kernel time ~1,000 times their wall once the script had run its
    earlier phases.)  On the CPU it records nothing."""

    def __init__(self, device):
        import torch
        self.on = device.type == "cuda"
        self.event = lambda: torch.cuda.Event(enable_timing=True)
        self.marks = []

    def start(self):
        if self.on:
            self.marks.append([self.event(), self.event()])
            self.marks[-1][0].record()

    def end(self):
        if self.on:
            self.marks[-1][1].record()

    def idle_between_steps(self):
        if not self.on:
            return None
        busy = sum(s.elapsed_time(e) for s, e in self.marks)
        return 1 - busy / self.marks[0][0].elapsed_time(self.marks[-1][1])


def fed_vs_memory(cfg, ds, batch_size, steps, lr, seed=0, device="cuda"):
    """``steps`` steps of ``make_lm_train_step(cfg)`` fed from ``ds``
    through ``iter_batches(drop_last=True)`` and ``device_put_iterator(
    prefetch=2)`` (the main path: launch counts are read from this window
    only), then the same steps from a clone of the same starting state on
    the same host batches placed from memory; each window's share of
    device time idle between its steps (``_StepMarks``)."""
    import torch
    from ray_tpu_torch._tree import tree_map
    from ray_tpu_torch.data import device_put_iterator
    from ray_tpu_torch.parallel import build_mesh, make_lm_train_step
    device = torch.device(device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (
        lambda: None)
    init_fn, step_fn, place = make_lm_train_step(
        cfg, build_mesh(device=device), learning_rate=lr,
        param_dtype=cfg.dtype)
    params, opt = init_fn(torch.Generator(device=device).manual_seed(seed))
    clone = lambda tree: tree_map(  # noqa: E731
        lambda x: x.clone() if isinstance(x, torch.Tensor) else x, tree)
    fed, mem = clone((params, opt)), clone((params, opt))
    warm = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch_size, cfg.max_seq_len + 1), np.int32)
    params, opt, _ = step_fn(params, opt, _split_rows(
        place({"t": warm})["t"]))         # allocator, cuBLAS handles
    del params, opt
    sync()

    host = []

    def keep(batches):
        for b in batches:
            host.append({k: np.array(v, copy=True) for k, v in b.items()})
            yield b

    it = device_put_iterator(keep(ds.iter_batches(
        batch_size=batch_size, drop_last=True)), prefetch=2, device=device)
    t0 = time.perf_counter()
    first = next(it)                     # the pipeline's start-up
    first_batch_s = time.perf_counter() - t0

    # -- the main path: counts from here.
    _reset_launches()
    waits, losses_fed = [], []
    p, o = fed
    marks_fed = _StepMarks(device)
    t0 = time.perf_counter()
    for i in range(steps):
        tw = time.perf_counter()
        dev = first if i == 0 else next(it)
        if i:
            waits.append(time.perf_counter() - tw)
        marks_fed.start()
        p, o, m = step_fn(p, o, _split_rows(dev["tokens"]))
        marks_fed.end()
        losses_fed.append(m["loss"])
    sync()
    fed_s = time.perf_counter() - t0
    launches = _read_launches()
    # -- end of the main path.
    it.close()
    del first, dev, p, o, fed

    losses_mem = []
    p, o = mem
    marks_mem = _StepMarks(device)
    t0 = time.perf_counter()
    for i in range(steps):
        batch = _split_rows(place({"t": host[i]["tokens"]})["t"])
        marks_mem.start()
        p, o, m = step_fn(p, o, batch)
        marks_mem.end()
        losses_mem.append(m["loss"])
    sync()
    mem_s = time.perf_counter() - t0
    del p, o, mem
    idle = {"fed": marks_fed.idle_between_steps(),
            "memory": marks_mem.idle_between_steps()}
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"losses_fed": [x.item() for x in losses_fed],
            "losses_memory": [x.item() for x in losses_mem],
            "first_batch_s": first_batch_s,
            "next_wait_ms": [w * 1e3 for w in waits],
            "step_ms_fed": fed_s * 1e3 / steps,
            "step_ms_memory": mem_s * 1e3 / steps,
            "idle_between_steps": idle, "launches": launches,
            "rows": np.concatenate([h["tokens"] for h in host])}


def phase_data_train(smi, device: str = "cuda"):
    """The 1.36B step of ``train`` fed from a Dataset on the card: a
    seeded int32 token corpus in raw shards through read tasks,
    ``map_batches`` to 2,049-token rows and the two-stage
    ``random_shuffle`` over ``ray_tpu_torch.init(num_cpus=4)``'s task
    workers, then ``iter_batches`` and ``device_put_iterator`` into
    ``make_lm_train_step``: 4 steps fed so, against 4 from a clone of the
    same state on the same host batches placed from memory (bit-equal
    losses).  The rows equal the corpus's as a multiset; a second run
    gives the same order; the flash kernels launch 2L, L and L a step in
    the fed window; the workers' row counts reach the driver's telemetry;
    no segment of the session is left after ``shutdown()``."""
    import glob
    import shutil
    import tempfile

    import torch
    import ray_tpu_torch as rtt
    from ray_tpu_torch import _tasks
    from ray_tpu_torch.data.context import DataContext
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.util import telemetry
    t_phase = time.perf_counter()
    try:
        import pyarrow
        pyarrow_version = pyarrow.__version__
    except ImportError:
        pyarrow_version = None
    shm_free = shutil.disk_usage("/dev/shm").free
    rows = DATA_ROWS
    row_bytes = DATA_ROW * 4

    def need(r):
        return DATA_SHM_COPIES * DATA_SHARDS * r * row_bytes

    while need(rows) > shm_free and rows * DATA_SHARDS > DATA_MIN_ROWS:
        rows = max(DATA_MIN_ROWS // DATA_SHARDS, rows // 2)
    emit({"phase": "data_train.shm", "dev_shm_free_bytes": shm_free,
          "rows_per_shard": rows, "needed_bytes": need(rows)})
    check(need(rows) <= shm_free,
          f"/dev/shm has {shm_free} bytes free; the pipeline needs "
          f"{need(rows)} at {rows * DATA_SHARDS} rows")
    cfg = LlamaConfig(**TRAIN_CFG, dtype=torch.bfloat16, remat=True,
                      attention_impl="flash")
    ctx = DataContext.get()
    old_order, ctx.preserve_order = ctx.preserve_order, True
    before = _tasks.stats()
    session = rtt.init(num_cpus=DATA_WORKERS)
    try:
        with tempfile.TemporaryDirectory(prefix="data_train_") as root:
            corpus = write_token_corpus(root, DATA_SHARDS, rows, DATA_ROW,
                                        cfg.vocab_size, seed=0)
            t0 = time.perf_counter()
            got = np.concatenate([
                b["tokens"] for b in token_pipeline(root, DATA_ROW)
                .iter_batches(batch_size=4096)])
            run1_s = time.perf_counter() - t0
            mid = _tasks.stats()
            res = fed_vs_memory(cfg, token_pipeline(root, DATA_ROW),
                                TRAIN_BATCH, DATA_STEPS, TRAIN_LR,
                                device=device)
            after = _tasks.stats()
    finally:
        ctx.preserve_order = old_order
        rtt.shutdown()
    left = glob.glob(f"/dev/shm/rtt_{session.id}_*")
    by_op = {dict(k)["operator"]: v[1] for k, v in
             telemetry.samples("ray_tpu_data_rows_total").items()}
    delta = lambda a, b, k: b.get(k, 0) - a.get(k, 0)  # noqa: E731
    per_step = {k: n / DATA_STEPS for k, n in res["launches"].items()}
    # On the CPU (a rehearsal) the wrappers run their plain versions.
    n = cfg.layers if device == "cuda" else 0
    want = {"flash_fwd": 2 * n, "flash_bwd_dq": n, "flash_bwd_dkv": n,
            "paged_decode": 0}
    same_order = bool(np.array_equal(res["rows"], got[:len(res["rows"])]))
    multiset = bool(len(got) == len(corpus) and np.array_equal(
        _row_multiset(got), _row_multiset(corpus)))
    waits = res["next_wait_ms"]
    emit({"phase": "data_train", "card": smi, "config": "bench.py:3384-3390",
          "batch": [TRAIN_BATCH, TRAIN_SEQ], "steps": DATA_STEPS,
          "workers": DATA_WORKERS, "pyarrow_on_card": pyarrow_version,
          "corpus": {"shards": DATA_SHARDS, "rows_per_shard": rows,
                     "row_tokens": DATA_ROW, "bytes": corpus.nbytes,
                     "cut_from_rows": DATA_ROWS * DATA_SHARDS
                     if rows != DATA_ROWS else None},
          "tasks_run": delta(before, after, "tasks_run"),
          "pipeline_run": {"seconds": run1_s, "rows": len(got),
                           "rows_per_s": len(got) / run1_s,
                           "driver_mapped_bytes": delta(
                               before, mid, "mapped_bytes")},
          "seconds_to_first_batch": res["first_batch_s"],
          "driver_mapped_bytes_fed": delta(mid, after, "mapped_bytes"),
          "step_ms": {"fed": res["step_ms_fed"],
                      "memory": res["step_ms_memory"]},
          "next_wait_ms_mean": sum(waits) / max(len(waits), 1),
          "next_wait_ms": waits,
          "idle_between_steps_share": res["idle_between_steps"],
          "losses": {"fed": res["losses_fed"],
                     "memory": res["losses_memory"]},
          "launches_per_step": per_step, "rows_by_operator": by_op,
          "rows_multiset_equal": multiset, "same_order": same_order,
          "segments_left": len(left),
          "seconds": time.perf_counter() - t_phase})
    check(multiset, "data_train: the pipeline's rows are not the corpus's")
    check(same_order, "data_train: a second run gave another order")
    check(res["losses_fed"] == res["losses_memory"],
          f"data_train: fed and from-memory losses differ: {res['losses_fed']}"
          f" vs {res['losses_memory']}")
    check(all(math.isfinite(x) for x in res["losses_fed"]),
          f"data_train losses {res['losses_fed']}")
    check(per_step == want, f"data_train launches a step {per_step} != "
          f"{want}")
    check(by_op.get("map", 0) >= len(corpus)
          and by_op.get("reduce", 0) >= len(corpus),
          f"data_train: rows by operator in the driver's telemetry {by_op}")
    check(not left, f"data_train: segments left after shutdown: {left}")
    for window, share in res["idle_between_steps"].items():
        check_share(share, f"data_train {window}")
    return {k: v for k, v in res["launches"].items() if v}


def phase_train_dots(smi, params, opt):
    """The train phase's config at full width and depth (bench.py:
    3384-3390, 12 x 2048, bf16) under remat "dots" and "dots_nobatch",
    continuing from the train phase's params: step ms, tokens/s, mfu, GEMM
    ms (cuBLAS device time in one profiled step), peak memory; then loss
    and gradients at B 2 against remat False (TOL_TRAIN_BF16)."""
    import torch
    from ray_tpu_torch.models.llama import LlamaConfig, num_params
    from ray_tpu_torch.parallel import build_mesh, make_lm_train_step
    rng = np.random.default_rng(12)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, TRAIN_CFG["vocab_size"], (TRAIN_BATCH, TRAIN_SEQ),
        dtype=np.int32)).cuda()}
    small = {"tokens": batch["tokens"][:2]}
    base = LlamaConfig(**TRAIN_CFG, dtype=torch.bfloat16,
                       attention_impl="flash")
    n_params = num_params(base)
    out, total = {}, {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    for mode in ("dots", "dots_nobatch"):
        cfg = base.replace(remat=mode)
        _i, step_fn, _p = make_lm_train_step(cfg, build_mesh(),
                                             learning_rate=TRAIN_LR)
        params, opt, m = step_fn(params, opt, batch)        # warm-up
        torch.cuda.synchronize()
        # -- the main path: launch counts read from this window only.
        _reset_launches()
        torch.cuda.reset_peak_memory_stats()
        steps, losses = 3, []
        t0 = time.perf_counter()
        for _ in range(steps):
            params, opt, m = step_fn(params, opt, batch)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_launches()
        peak = torch.cuda.max_memory_allocated()
        # -- end of the main path.
        step_s = wall / steps
        busy_ms, top, kinds = _device_time(
            lambda: step_fn(params, opt, batch), top=8)
        got = _loss_and_grads(cfg, params, small)
        want = _loss_and_grads(base.replace(remat=False), params, small)
        worst, where = _worst_layer_err(got[2], want[2])
        errs = {"loss": abs(got[0] - want[0]) / abs(want[0]),
                "grad_norm": abs(got[1] - want[1]) / abs(want[1]),
                "attn_grad": worst}
        tok_s = TRAIN_BATCH * TRAIN_SEQ / step_s
        out[mode] = {
            "step_ms": step_s * 1e3, "tokens_per_s": tok_s,
            "mfu": 6.0 * n_params * tok_s / PEAK_BF16_FLOPS,
            "gemm_ms": kinds.get("matmul (cuBLAS)"),
            "peak_mem_gb": peak / 2**30, "losses": [x.item() for x in losses],
            "launches_per_step": {k: n / steps for k, n in launches.items()},
            "profile_one_step": {"device_busy_ms": busy_ms,
                                 "device_ms_by_kind": kinds},
            "vs_remat_false_B2": {"rel_err": errs, "worst_at": where,
                                  "tol": TOL_TRAIN_BF16}}
        check(all(errs[k] <= TOL_TRAIN_BF16[k] for k in errs),
              f"train_dots {mode}: {errs}")
        check(all(math.isfinite(x) for x in out[mode]["losses"]),
              f"train_dots {mode} losses")
        want_l = {"flash_fwd": 2 * cfg.layers, "flash_bwd_dq": cfg.layers,
                  "flash_bwd_dkv": cfg.layers}
        check({k: out[mode]["launches_per_step"][k] for k in want_l}
              == want_l, f"train_dots {mode} launches {launches}")
        for k in total:
            total[k] += launches[k]
    emit(dict({"phase": "train_dots", "config": "bench.py:3384-3390",
               "card": smi, "num_params": n_params,
               "batch": [TRAIN_BATCH, TRAIN_SEQ]}, **out))
    return total


# The checkpoint phase's config: the train config's width at 4 layers.
CKPT_CFG = dict(TRAIN_CFG, layers=4)
CKPT_BATCH = 4


def phase_checkpoint(smi):
    """Two adamw steps of the train config's width at 4 layers (bf16
    params and adam state), a save through checkpoint/format.py, a restore
    onto the card, then step 3: equal to three uninterrupted steps, leaf
    by leaf (bit-exact, or the differing leaves named and held within
    1e-6 relative)."""
    import shutil
    import tempfile

    import torch
    from ray_tpu_torch import optim
    from ray_tpu_torch._tree import (tree_flatten_with_keys, tree_leaves,
                                     tree_map)
    from ray_tpu_torch.checkpoint import format as ckpt
    from ray_tpu_torch.models.llama import LlamaConfig, num_params
    from ray_tpu_torch.parallel import build_mesh, make_lm_train_step
    cfg = LlamaConfig(**CKPT_CFG, dtype=torch.bfloat16, remat=True,
                      attention_impl="flash")
    init_fn, step_fn, place = make_lm_train_step(
        cfg, build_mesh(), learning_rate=TRAIN_LR,
        param_dtype=torch.bfloat16)
    rng = np.random.default_rng(13)
    batches = [place({"tokens": rng.integers(
        0, cfg.vocab_size, (CKPT_BATCH, TRAIN_SEQ), dtype=np.int32)})
        for _ in range(3)]
    # -- the main path: launch counts read from this window only.
    _reset_launches()
    params, opt = init_fn(torch.Generator(device="cuda").manual_seed(0))
    for b in batches[:2]:
        params, opt, _m = step_fn(params, opt, b)
    torch.cuda.synchronize()
    # Scratch inside the checkout, in a directory git ignores.
    where = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_chip")
    os.makedirs(where, exist_ok=True)
    path = tempfile.mkdtemp(prefix="ckpt-", dir=where)
    try:
        t0 = time.perf_counter()
        snap = ckpt.save(path, {"params": params,
                                "opt_state": optim.optax_state(opt)},
                         step=2)
        save_s = time.perf_counter() - t0
        nbytes = ckpt.read_manifest(path)["total_bytes"]
        problems = ckpt.verify_checkpoint(path, deep=True)
        params, opt, m3 = step_fn(params, opt, batches[2])   # uninterrupted
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree = ckpt.restore_tree(path)
        r_params = tree_map(lambda t: t.to("cuda").requires_grad_(True),
                            tree["params"])
        r_opt = optim.from_optax_state(tree["opt_state"])
        r_opt = optim.AdamState(r_opt.count, tree_map(
            lambda t: t.to("cuda"), r_opt.mu), tree_map(
            lambda t: t.to("cuda"), r_opt.nu))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        r_params, r_opt, r3 = step_fn(r_params, r_opt, batches[2])
        torch.cuda.synchronize()
        launches = _read_launches()
        # -- end of the main path.
    finally:
        shutil.rmtree(path, ignore_errors=True)
    differ = {}
    for (key, a), b in zip(
            tree_flatten_with_keys({"params": params, "mu": opt.mu,
                                    "nu": opt.nu}),
            tree_leaves({"params": r_params, "mu": r_opt.mu,
                         "nu": r_opt.nu})):
        if not torch.equal(a, b):
            differ[key] = ((a.float() - b.float()).norm()
                           / a.float().norm().clamp_min(1e-30)).item()
    res = {"phase": "checkpoint", "card": smi,
           "config": "bench.py:3384-3390 width, 4 layers",
           "num_params": num_params(cfg), "bytes": nbytes,
           "snapshot_bytes": snap.nbytes, "save_s": save_s,
           "restore_s": restore_s, "verify_problems": problems,
           "loss_step3": [m3["loss"].item(), r3["loss"].item()],
           "count": [int(opt.count), int(r_opt.count)],
           "leaves": len(tree_leaves(params)) * 3,
           "leaves_differing": differ, "launches": launches}
    emit(res)
    check(not problems, f"checkpoint verify {problems}")
    check(res["loss_step3"][0] == res["loss_step3"][1]
          and res["count"] == [3, 3], f"checkpoint step 3 {res}")
    check(all(v <= 1e-6 for v in differ.values()),
          f"checkpoint: leaves differ after restore {differ}")
    return {k: launches[k] for k in ("flash_fwd", "flash_bwd_dq",
                                     "flash_bwd_dkv")}


# trainer: TorchTrainer.fit with one worker on the card, the checkpoint
# phase's config (bench.py:3384-3390 width at 4 layers: a 24-layer save is
# ~8.2 GB, ~30-38 s a save at the checkpoint phase's rate).  Async saves
# after the steps in TRAINER_SAVE_AT; after step TRAINER_DIE_AT, once that
# save is committed, the worker dies (os._exit(1)) and the restarted group
# resumes from the checkpoint.  Batches come from
# default_rng(TRAINER_SEED + step), so a resumed run replays the same ones.
TRAINER_STEPS = 6
TRAINER_SAVE_AT = (1, 4)
TRAINER_DIE_AT = 3
TRAINER_SEED = 17


def _trainer_batches(vocab: int, start: int, batch: int = CKPT_BATCH,
                     steps: int = TRAINER_STEPS):
    for step in range(start, steps):
        rng = np.random.default_rng(TRAINER_SEED + step)
        yield {"tokens": rng.integers(0, vocab, (batch, TRAIN_SEQ),
                                      dtype=np.int32)}


def _trainer_state(init_fn, state):
    """(params, adamw state, first step): fresh from the seeded init, or
    the restored checkpoint moved to the card."""
    import torch
    from ray_tpu_torch import optim
    from ray_tpu_torch._tree import tree_map
    if state is None:
        params, opt = init_fn(torch.Generator(device="cuda").manual_seed(0))
        return params, opt, 0
    on_card = lambda t: t.to("cuda")                         # noqa: E731
    params = tree_map(lambda t: on_card(t).requires_grad_(True),
                      state["params"])
    opt = optim.from_optax_state(state["opt_state"])
    opt = optim.AdamState(opt.count, tree_map(on_card, opt.mu),
                          tree_map(on_card, opt.nu))
    return params, opt, int(state["step"])


def trainer_train_fn(config):
    """The trainer phase's train fn, run by the spawned worker (module
    level: the worker imports it from this file)."""
    import torch
    import ray_tpu_torch.train as train
    from ray_tpu_torch import optim
    from ray_tpu_torch.checkpoint.format import is_committed
    from ray_tpu_torch.data import device_put_iterator
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.parallel import make_lm_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = train.get_context()
    cfg = LlamaConfig(**CKPT_CFG, dtype=torch.bfloat16, remat=True,
                      attention_impl="flash")
    init_fn, step_fn, _place = make_lm_train_step(
        cfg, train.get_mesh(), learning_rate=TRAIN_LR,
        param_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    state = train.load_checkpoint()
    params, opt, start = _trainer_state(init_fn, state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0 if state is not None else None
    del state
    batches = device_put_iterator(_trainer_batches(cfg.vocab_size, start))
    for step in range(start, TRAINER_STEPS):
        batch = next(batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        loss = m["loss"].item()
        metrics = {"step": step, "loss": loss,
                   "step_ms": (time.perf_counter() - t0) * 1e3,
                   "wall": time.time(), "resumed_from": start,
                   "restore_s": restore_s if step == start else None,
                   "launches": _read_launches()}
        if step in TRAINER_SAVE_AT:
            t0 = time.perf_counter()
            path = train.save_checkpoint(
                {"params": params, "opt_state": optim.optax_state(opt),
                 "step": step + 1})
            metrics["ckpt_block_s"] = time.perf_counter() - t0
        train.report(metrics)
        if step == TRAINER_DIE_AT and not os.path.exists(config["marker"]):
            # The planted failure, once the save before it is committed.
            ctx.checkpoint_client().flush()
            while not is_committed(path):
                time.sleep(0.01)
            open(config["marker"], "w").close()
            train.report({"planted_death": time.time()})
            os._exit(1)


def phase_trainer(smi):
    """TorchTrainer.fit (one worker on the card) through a planted failure
    and its restart, held to the same steps run bare in this process:
    bit-exact losses, or the differing steps named and held within 1e-6
    relative.  The worker reports its flash launch counts (the counts of
    this process see nothing of a spawned one)."""
    import shutil
    import tempfile

    import torch
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.parallel import build_mesh, make_lm_train_step
    from ray_tpu_torch.train import (FailureConfig, RunConfig,
                                     ScalingConfig, TorchTrainer)
    from ray_tpu_torch.util import telemetry
    # The bare run: the same steps, init and batches in this process.
    cfg = LlamaConfig(**CKPT_CFG, dtype=torch.bfloat16, remat=True,
                      attention_impl="flash")
    init_fn, step_fn, place = make_lm_train_step(
        cfg, build_mesh(), learning_rate=TRAIN_LR,
        param_dtype=torch.bfloat16)
    params, opt, _ = _trainer_state(init_fn, None)
    bare_loss, bare_ms = [], []
    for b in _trainer_batches(cfg.vocab_size, 0):
        b = place(b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, b)
        bare_loss.append(m["loss"].item())
        bare_ms.append((time.perf_counter() - t0) * 1e3)
    del params, opt, m, b
    torch.cuda.empty_cache()
    where = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_chip")
    os.makedirs(where, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="trainer-", dir=where)
    telemetry._reset_for_tests()
    try:
        t0 = time.perf_counter()
        result = TorchTrainer(
            trainer_train_fn,
            train_loop_config={"marker": os.path.join(tmp, "died")},
            scaling_config=ScalingConfig(num_workers=1),
            run_config=RunConfig(name="trainer", storage_path=tmp,
                                 failure_config=FailureConfig(
                                     max_failures=1))).fit()
        fit_s = time.perf_counter() - t0
        problems = (result.checkpoint.validate(deep=True)
                    if result.checkpoint is not None else ["no checkpoint"])
        committed = (result.checkpoint is not None
                     and result.checkpoint.manifest() is not None)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(result.error is None, f"trainer fit failed: {result.error}")
    steps = [r["metrics"] for r in result.all_reports
             if "step" in r["metrics"]]
    death = [r["metrics"]["planted_death"] for r in result.all_reports
             if "planted_death" in r["metrics"]]
    resumed = [m for m in steps if m["resumed_from"] > 0]
    first = [m for m in steps if m["resumed_from"] == 0]
    differ = {m["step"]: abs(m["loss"] - bare_loss[m["step"]])
              / abs(bare_loss[m["step"]]) for m in steps
              if m["loss"] != bare_loss[m["step"]]}
    # Launches: each incarnation's last report holds its process's counts.
    launches = {}
    for group in (first, resumed):
        for k, n in (group[-1]["launches"] if group else {}).items():
            launches[k] = launches.get(k, 0) + n
    writes = telemetry.samples("ray_tpu_ckpt_write_seconds")
    write = next(iter(writes.values()), None)
    res = {"phase": "trainer", "card": smi,
           "config": "bench.py:3384-3390 width, 4 layers",
           "batch": [CKPT_BATCH, TRAIN_SEQ], "steps": TRAINER_STEPS,
           "saves_after": TRAINER_SAVE_AT, "planted_death_after":
           TRAINER_DIE_AT, "fit_s": fit_s,
           "num_failures": result.num_failures,
           "formation_s": result.formation_seconds,
           "step_ms_fit": [m["step_ms"] for m in steps],
           "step_ms_bare": bare_ms,
           "ckpt_block_s": [m["ckpt_block_s"] for m in steps
                            if "ckpt_block_s" in m],
           "write_s_after_resume": (write[2] / write[1]) if write else None,
           "restore_s": [m["restore_s"] for m in resumed[:1]],
           "time_to_recover_s": (resumed[0]["wall"] - death[0])
           if resumed and death else None,
           "loss_fit": [[m["step"], m["loss"]] for m in steps],
           "loss_bare": bare_loss, "steps_differing": differ,
           "goodput": result.goodput, "step_phases": result.step_phases,
           "checkpoint_problems": problems, "launches": launches}
    emit(res)
    check(result.num_failures == 1, f"trainer num_failures {res}")
    check(bool(death) and [m["step"] for m in resumed]
          == list(range(TRAINER_SAVE_AT[0] + 1, TRAINER_STEPS)),
          f"trainer did not resume after the first save: {res}")
    check(committed and not problems, f"trainer checkpoint {problems}")
    check(all(v <= 1e-6 for v in differ.values()),
          f"trainer losses differ from the bare run: {differ}")
    return {k: launches.get(k, 0) for k in ("flash_fwd", "flash_bwd_dq",
                                            "flash_bwd_dkv")}


# sched_cards: the card as the scheduler's GPU.  Each card task launches
# the flash forward at the serving shape (B1 H16 Hkv8 S256 D128, bf16)
# in a task worker pinned to its granted card.
SCHED_SHAPE = dict(B=1, H=16, Hkv=8, S=256, D=128)


def sched_card_task(seed: int):
    """A task holding one card: what it sees, and the flash forward held
    against its plain version (module level: the worker imports it)."""
    t_run = time.time()
    import torch
    from ray_tpu_torch.ops.attention import flash_fwd, reference_attention
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    count = torch.cuda.device_count()
    if count != 1:
        raise RuntimeError(f"a one-card task sees {count} cards "
                           f"(CUDA_VISIBLE_DEVICES={visible!r})")
    sh = SCHED_SHAPE
    q, k, v = _flash_inputs(sh["B"], sh["H"], sh["Hkv"], sh["S"], sh["S"],
                            sh["D"], torch.bfloat16, seed)
    flash_fwd.launches = 0
    out, _ = flash_fwd(q, k, v, causal=True)
    launches = flash_fwd.launches
    ref = reference_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    return {"run": t_run, "end": time.time(), "visible": visible,
            "device_count": count, "launches": launches,
            "max_abs_err": (out.float() - ref.float()).abs().max().item(),
            "pid": os.getpid()}


def sched_double(x):
    return x * 2


def sched_outer():
    import ray_tpu_torch as rtt
    return rtt.get(rtt.remote(sched_double).remote(100)) + 1


def _smi_cards() -> int:
    import subprocess
    out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                         text=True, timeout=60)
    return sum(1 for line in out.stdout.splitlines()
               if line.startswith("GPU "))


def phase_sched_cards(smi):
    """Tasks booking the card through the scheduler tier (see
    ``SCHED_SHAPE``): the count against ``nvidia-smi``, two card tasks
    serialised on one card, a placement group holding it, an infeasible
    two-card ask, a nested task, and every resource back at the end."""
    import ray_tpu_torch as rtt
    t0 = time.perf_counter()
    tol = TOL["bfloat16"]
    session = rtt.init(num_cpus=4)
    sched = session.node.scheduler
    try:
        cards = _smi_cards()
        total = rtt.cluster_resources()
        check(total.get("GPU") == cards,
              f"the node advertises {total.get('GPU')} cards, nvidia-smi "
              f"lists {cards}")
        card_task = rtt.remote(num_tpus=1)(sched_card_task)
        t_submit = time.time()
        a, b = card_task.remote(1), card_task.remote(2)
        ra, rb = rtt.get([a, b], timeout=600)
        first, second = sorted((ra, rb), key=lambda r: r["run"])
        check(first["end"] <= second["run"],
              f"two one-card tasks overlapped: {ra} {rb}")
        placed = {}
        for rec in sched.ring.snapshot(limit=10_000):
            if rec["name"] == "sched_card_task" and rec["kind"] in (
                    "inline", "loop"):
                placed.setdefault(rec["task_id"], rec["time"])
        book_to_run = [r["run"] - t for r, t in zip(
            (first, second), sorted(placed.values()))]
        # A placement group holds the card: a task inside runs, one
        # outside waits until the group is removed.
        pg = rtt.placement_group([{"GPU": 1}])
        check(pg.ready(timeout=60), "the card's placement group")
        inside = rtt.get(rtt.remote(
            num_cpus=0, num_tpus=1, placement_group=pg,
            placement_group_bundle_index=0)(sched_card_task).remote(3),
            timeout=600)
        outside = card_task.remote(4)
        time.sleep(2.0)
        waited = not outside._fut.done()
        rtt.remove_placement_group(pg)
        after_pg = rtt.get(outside, timeout=600)
        check(waited, "a one-card task ran while a placement group held "
                      "the card")
        # Two cards asked of one: parked as infeasible, never run.
        infeasible = rtt.remote(num_tpus=cards + 1)(sched_card_task).remote(5)
        deadline = time.monotonic() + 30
        while sched.queue_depths()["infeasible"] < 1 and \
                time.monotonic() < deadline:
            time.sleep(0.02)
        parked = sched.queue_depths()["infeasible"]
        check(parked >= 1 and not infeasible._fut.done(),
              "a two-card ask on one card was not parked as infeasible")
        nested = rtt.get(rtt.remote(sched_outer).remote(), timeout=120)
        check(nested == 201, f"nested task gave {nested}")
        runs = [first, second, inside, after_pg]
        avail = rtt.available_resources()
        res = {"phase": "sched_cards", "card": smi, "cards": cards,
               "cluster_resources": {k: v for k, v in total.items()
                                     if k != "memory"},
               "shape": SCHED_SHAPE, "dtype": "bfloat16", "tol": tol,
               "start_s": [r["run"] - t_submit for r in (first, second)],
               "booking_to_run_ms": [1e3 * x for x in book_to_run],
               "visible": [r["visible"] for r in runs],
               "max_abs_err": max(r["max_abs_err"] for r in runs),
               "pids": [r["pid"] for r in runs],
               "waited_for_pg": waited, "infeasible_parked": parked,
               "nested": nested,
               "decisions": sched.ring.stats()["counts"],
               "available_after": {k: v for k, v in avail.items()
                                   if k != "memory"},
               "launches": {"flash_fwd": sum(r["launches"] for r in runs)},
               "seconds": time.perf_counter() - t0}
        emit(res)
        check(all(r["device_count"] == 1 for r in runs),
              f"card tasks' device counts {res}")
        check(res["max_abs_err"] <= tol, f"flash forward in a card task "
                                         f"{res['max_abs_err']} > {tol}")
        check(all(r["launches"] == 1 for r in runs),
              f"card tasks' flash launches {res['launches']}")
        check(avail.get("GPU") == total.get("GPU")
              and avail.get("CPU") == total.get("CPU"),
              f"resources not back after the phase: {avail}")
    finally:
        rtt.shutdown()
    return res["launches"]


# tune: Tuner.fit over the trainer phase's 4-layer 1.36B step on the card.
TUNE_TRIALS = 4
TUNE_STEPS = 6
TUNE_BATCH = 2


def tune_trial(config):
    """One trial: the 4-layer 1.36B step (bf16, full remat, flash) from the
    seeded init, on the trainer phase's batches at ``TUNE_BATCH``; each
    step reported, its kernels' launches in the last report (module level:
    the trial worker imports it)."""
    import torch
    import ray_tpu_torch.tune as tune
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.parallel import build_mesh, make_lm_train_step
    t_start = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _reset_launches()
    cfg = LlamaConfig(**CKPT_CFG, dtype=torch.bfloat16, remat=True,
                      attention_impl="flash")
    init_fn, step_fn, place = make_lm_train_step(
        cfg, build_mesh(), learning_rate=config["lr"],
        param_dtype=torch.bfloat16)
    params, opt, _ = _trainer_state(init_fn, None)
    for step, b in enumerate(_trainer_batches(cfg.vocab_size, 0,
                                              TUNE_BATCH, TUNE_STEPS)):
        b = place(b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, b)
        loss = m["loss"].item()
        tune.report({"loss": loss, "step": step + 1,
                     "step_ms": (time.perf_counter() - t0) * 1e3,
                     "start": t_start, "wall": time.time(),
                     "launches": _read_launches()})
    return {"loss": loss}


class _RecordingASHA:
    """An ``ASHAScheduler`` that keeps every (trial, step, value, decision)
    the tuner asked it for, in the tuner's order."""

    def __init__(self, **kw):
        from ray_tpu_torch.tune import ASHAScheduler
        self.kw = kw
        self.asha = ASHAScheduler(**kw)
        self.calls = []

    def on_result(self, trial_id, step, value):
        decision = self.asha.on_result(trial_id, step, value)
        self.calls.append((trial_id, step, value, decision))
        return decision

    def replayed(self):
        """The decisions a fresh ASHA gives the same reports in order."""
        from ray_tpu_torch.tune import ASHAScheduler
        asha = ASHAScheduler(**self.kw)
        return [asha.on_result(t, s, v) for t, s, v, _d in self.calls]


def phase_tune(smi):
    """``Tuner.fit`` on the card: ``TUNE_TRIALS`` trials drawing ``lr``
    from ``loguniform(1e-5, 1e-3)`` (seed 0), ASHA (max_t 6, grace 2,
    reduction 2), two trials at a time sharing the card.  Every trial
    reports; ASHA's decisions are its rule over the reports in the order
    the tuner read them (replayed), and a trial stopped early had a stop;
    the best result is the lowest last loss; the lowest ``lr``'s losses
    equal the same steps run bare in this process, bit for bit.  Whether
    ASHA stops a trial at all depends on that order (see PERF.md §6)."""
    import torch

    import ray_tpu_torch as rtt
    from ray_tpu_torch import tune
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.parallel import build_mesh, make_lm_train_step
    from ray_tpu_torch.tune.search import generate_variants
    space = {"lr": tune.loguniform(1e-5, 1e-3)}
    lr_min = min(v["lr"] for v in generate_variants(space, TUNE_TRIALS, 0))
    cfg = LlamaConfig(**CKPT_CFG, dtype=torch.bfloat16, remat=True,
                      attention_impl="flash")
    init_fn, step_fn, place = make_lm_train_step(
        cfg, build_mesh(), learning_rate=lr_min, param_dtype=torch.bfloat16)
    params, opt, _ = _trainer_state(init_fn, None)
    bare_loss, bare_ms = [], []
    for b in _trainer_batches(cfg.vocab_size, 0, TUNE_BATCH, TUNE_STEPS):
        b = place(b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, b)
        bare_loss.append(m["loss"].item())
        bare_ms.append((time.perf_counter() - t0) * 1e3)
    del params, opt, m, b
    gc.collect()
    torch.cuda.empty_cache()
    asha = _RecordingASHA(metric="loss", mode="min", max_t=TUNE_STEPS,
                          grace_period=2, reduction_factor=2)
    rtt.init(num_cpus=2)
    try:
        t0 = time.time()
        grid = tune.Tuner(
            tune_trial, param_space=space,
            tune_config=tune.TuneConfig(
                metric="loss", mode="min", num_samples=TUNE_TRIALS,
                max_concurrent_trials=2, seed=0, scheduler=asha)).fit()
        wall = time.time() - t0
    finally:
        rtt.shutdown()
    trials = list(grid)
    launches = {}
    for r in trials:
        for k, n in (r.history[-1]["launches"] if r.history else {}).items():
            launches[k] = launches.get(k, 0) + n
    low = min(trials, key=lambda r: r.config["lr"])
    got = [h["loss"] for h in low.history]
    best = grid.get_best_result()
    res = {"phase": "tune", "card": smi,
           "config": "bench.py:3384-3390 width, 4 layers",
           "batch": [TUNE_BATCH, TRAIN_SEQ], "trials": TUNE_TRIALS,
           "max_concurrent_trials": 2,
           "asha": {"max_t": TUNE_STEPS, "grace_period": 2,
                    "reduction_factor": 2},
           "trials_wall_s": wall,
           "first_report_s": min(h["wall"] for r in trials
                                 for h in r.history[:1]) - t0,
           "trial_rows": [{"lr": r.config["lr"], "steps": len(r.history),
                           "stopped_early": r.stopped_early,
                           "error": r.error,
                           "last_loss": r.metrics.get("loss"),
                           "losses": [h["loss"] for h in r.history],
                           "step_ms": [h["step_ms"] for h in r.history]}
                          for r in trials],
           "step_ms_bare": bare_ms, "loss_bare": bare_loss,
           # Medians past each run's first step (its warm-up).
           "step_ms_median_trial": float(np.median(
               [ms for r in trials for ms in
                [h["step_ms"] for h in r.history][1:]])),
           "step_ms_median_bare": float(np.median(bare_ms[1:])),
           "loss_lowest_lr": got, "best_lr": best.config["lr"],
           "asha_stops": [[c[1], c[2]] for c in asha.calls
                          if c[3] == "STOP"],
           "stopped_early": sum(r.stopped_early for r in trials),
           "launches": launches}
    emit(res)
    check(len(trials) == TUNE_TRIALS and all(
        r.error is None and r.history for r in trials),
        f"not every trial reported: {res['trial_rows']}")
    check(len(asha.calls) == sum(len(r.history) for r in trials),
          "the tuner did not hand ASHA every report")
    check(asha.replayed() == [c[3] for c in asha.calls],
          "ASHA's decisions differ from its rule replayed in order")
    stopped = {c[0] for c in asha.calls if c[3] == "STOP"}
    check(all(trial.trial_id in stopped for trial in trials
              if trial.stopped_early),
          "a trial stopped early without a stop from ASHA")
    check(best.metrics["loss"] == min(r.metrics["loss"] for r in trials),
          "get_best_result is not the lowest last loss")
    check(got == bare_loss[:len(got)],
          f"the lowest lr's losses {got} differ from the bare run "
          f"{bare_loss}")
    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(launches.get(k, 0) > 0, f"{k} never launched in a trial")
    return {k: launches.get(k, 0) for k in ("flash_fwd", "flash_bwd_dq",
                                            "flash_bwd_dkv")}


# ring_local: ring attention's per-step code over RING_BLOCKS blocks of one
# sequence in one process, at the long-context shape below (bf16, causal).
RING_SHAPE = dict(B=2, H=16, Hkv=16, S=8192, D=128)
RING_BLOCKS = 4


def _plain_attention_grads(q, k, v, out, lse, dout, heads=4):
    """The plain version's output and (dq, dk, dv) from the same inputs,
    a few heads at a time (the [S, S] fp32 matrices of all heads would
    not fit beside the rest)."""
    import torch
    from ray_tpu_torch.ops.attention import (_flash_bwd_plain,
                                             reference_attention)
    scale = 1.0 / math.sqrt(q.shape[-1])
    outs, grads = [], []
    for h in range(0, q.shape[1], heads):
        sl = slice(h, h + heads)
        outs.append(reference_attention(q[:, sl], k[:, sl], v[:, sl]))
        grads.append(_flash_bwd_plain(q[:, sl], k[:, sl], v[:, sl],
                                      out[:, sl], lse[:, sl], dout[:, sl],
                                      True, scale, 0))
        torch.cuda.synchronize()
    return torch.cat(outs, 1), [torch.cat(g, 1) for g in zip(*grads)]


SDPA_FLASH = "aten._scaled_dot_product_flash_attention"


def _sdpa_flash_ms(q, k, v, dout, causal: bool, scale: float):
    """Graph-replay ms of the library's flash attention at a ring step's
    shape: the forward with its logsumexp (``return_debug_mask=False``),
    and its backward given that out and logsumexp, as a ring step's
    backward is given the merged ones."""
    import torch
    fwd = torch.ops.aten._scaled_dot_product_flash_attention
    bwd = torch.ops.aten._scaled_dot_product_flash_attention_backward
    res = fwd(q, k, v, 0.0, causal, False, scale=scale)
    out, lse, cum_q, cum_k, max_q, max_k, seed, offset = res[:8]
    fwd_ms = graph_ms(lambda: fwd(q, k, v, 0.0, causal, False,
                                  scale=scale), 10)
    bwd_ms = graph_ms(lambda: bwd(dout, q, k, v, out, lse, cum_q, cum_k,
                                  max_q, max_k, 0.0, causal, seed, offset,
                                  scale=scale), 10)
    return fwd_ms, bwd_ms


def phase_ring_local(smi):
    """Ring attention over RING_BLOCKS blocks of one sequence in one
    process (ops.ring_attention.ring_attention_local: the ring's per-step
    flash calls and LSE merges, no transport), forward and backward,
    against one flash call over the whole sequence (flash_fwd + flash_bwd)
    and against the plain version; times of both, the per-step calls at
    the block shape (causal and full, with their bounds), and the kernel
    launches of the ring's run."""
    import torch
    from ray_tpu_torch.ops.attention import (flash_bwd, flash_bwd_dkv,
                                             flash_bwd_dq, flash_fwd)
    from ray_tpu_torch.ops.ring_attention import ring_attention_local
    B, H, Hkv, S, D = (RING_SHAPE[k] for k in ("B", "H", "Hkv", "S", "D"))
    n = RING_BLOCKS
    q, k, v, out1, lse1, dout = _bwd_inputs(B, H, Hkv, S, S, D,
                                            torch.bfloat16, True, 0, 21)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]

    def ring():
        o = ring_attention_local(*leaves, n, causal=True)
        return (o,) + torch.autograd.grad(o, leaves, dout)

    def single():
        o, lse = flash_fwd(q, k, v, causal=True, need_lse=True)
        return (o,) + flash_bwd(q, k, v, o, lse, dout, causal=True)

    ring()                                   # warm-up
    torch.cuda.synchronize()
    # -- the main path: launch counts read from this window only.
    _reset_launches()
    got = ring()
    torch.cuda.synchronize()
    launches = _read_launches()
    # -- end of the main path.
    one = single()
    plain_out, plain_grads = _plain_attention_grads(q, k, v, out1, lse1,
                                                    dout)
    errs = {"vs_one_flash_call": {}, "vs_plain": {}}
    for name, a, b, c in zip(("out", "dq", "dk", "dv"), got, one,
                             (plain_out,) + tuple(plain_grads)):
        for key, ref in (("vs_one_flash_call", b), ("vs_plain", c)):
            if name == "out":
                errs[key][name] = {"max_abs": (a.float() - ref.float())
                                   .abs().max().item(),
                                   "row_rel": row_rel_err(a, ref)}
            else:
                errs[key][name] = {"max_rel": _grad_errs(a, ref)[1],
                                   "row_rel": row_rel_err(a, ref,
                                                          BWD_ROW_FLOOR)}
    del plain_out, plain_grads, one
    torch.cuda.empty_cache()
    ring_ms, single_ms = time_ms(ring, 5), time_ms(single, 5)
    # The per-step calls at the block shape: the diagonal block (causal)
    # and an earlier one (every key visible), forward and backward.
    Sl = S // n
    scale = 1.0 / math.sqrt(D)
    steps = {}
    for tag, causal in (("causal", True), ("full", False)):
        qb, kb, vb, ob, lb, db = _bwd_inputs(B, H, Hkv, Sl, Sl, D,
                                             torch.bfloat16, causal, 0, 22)
        pairs = Sl * (Sl + 1) // 2 if causal else Sl * Sl
        io = 2 * (2 * B * H * Sl * D + 2 * B * Hkv * Sl * D)
        fwd_ms = graph_ms(lambda: flash_fwd(qb, kb, vb, causal=causal,
                                            need_lse=True), 10)
        bwd_ms = graph_ms(lambda: flash_bwd(qb, kb, vb, ob, lb, db,
                                            causal=causal, scale=scale), 10)
        lib_fwd_ms, lib_bwd_ms = _sdpa_flash_ms(qb, kb, vb, db, causal,
                                                scale)
        steps[tag] = {
            "fwd": dict(_timing_row(
                "flash_fwd", {"B": B, "H": H, "Hkv": Hkv, "S": Sl, "D": D,
                              "causal": causal}, fwd_ms, None, lib_fwd_ms,
                4 * B * H * D * pairs, io + 4 * B * H * Sl, None),
                timed_by="graph", library=SDPA_FLASH),
            "bwd": dict(_timing_row(
                "flash_bwd (dq + dk/dv)", {"B": B, "H": H, "Hkv": Hkv,
                                           "S": Sl, "D": D,
                                           "causal": causal},
                bwd_ms, None, lib_bwd_ms, 14 * B * H * D * pairs,
                io + 2 * B * H * Sl * D + 4 * B * H * Sl
                + 2 * 2 * B * Hkv * Sl * D, None), timed_by="graph",
                library=SDPA_FLASH + "_backward, given its out and LSE")}
        del qb, kb, vb, ob, lb, db
    visible = n * (n + 1) // 2
    res = {"phase": "ring_local", "card": smi, "shape": RING_SHAPE,
           "blocks": n, "dtype": "bfloat16", "causal": True,
           "ms_fwd_bwd": ring_ms, "one_flash_call_ms_fwd_bwd": single_ms,
           "slowdown": ring_ms / single_ms, "errors": errs,
           "tol": {"out": TOL["bfloat16"], "out_row_rel":
                   TOL_ROW_REL["bfloat16"], "grad_max_rel":
                   TOL_BWD["bfloat16"], "grad_row_rel":
                   TOL_BWD_ROW_REL["bfloat16"]},
           "launches": launches, "per_step_calls": steps}
    emit(res)
    check(launches == {"flash_fwd": visible, "paged_decode": 0,
                       "flash_bwd_dq": visible, "flash_bwd_dkv": visible},
          f"ring_local launches {launches}")
    for key in errs:
        e = errs[key]
        check(e["out"]["max_abs"] <= TOL["bfloat16"]
              and e["out"]["row_rel"] <= TOL_ROW_REL["bfloat16"]
              and all(e[g]["max_rel"] <= TOL_BWD["bfloat16"]
                      and e[g]["row_rel"] <= TOL_BWD_ROW_REL["bfloat16"]
                      for g in ("dq", "dk", "dv")),
              f"ring_local {key}: {e}")
    return {k: launches[k] for k in ("flash_fwd", "flash_bwd_dq",
                                     "flash_bwd_dkv")}


# train_moe: llama_1b's widths and depth (bench.py has no MoE config) with
# 8 experts (Mixtral's count), top-2 and capacity factor 1.25 (the JAX
# package's defaults), bf16 params and adam state, full remat, batch 4 x
# 2048, adamw at lr 1e-4.
MOE_CFG = dict(vocab_size=32000, hidden=2048, layers=16, heads=16,
               kv_heads=8, head_dim=128, mlp_dim=5504, max_seq_len=2048,
               num_experts=8, moe_top_k=2, moe_capacity_factor=1.25)
MOE_BATCH = 4


def active_params(cfg) -> int:
    """Parameters a token passes through: num_params with the experts'
    MLPs counted moe_top_k times instead of num_experts times (a dense
    config: num_params)."""
    from ray_tpu_torch.models.llama import num_params
    per_expert = 3 * cfg.hidden * cfg.mlp_dim
    return num_params(cfg) - cfg.layers * per_expert * max(
        cfg.num_experts - cfg.moe_top_k, 0)


def _moe_dispatch_check():
    """fp32 on the card, small: sorted dispatch with room for every
    assignment equals dense dispatch."""
    import torch
    from ray_tpu_torch.ops.moe import moe_layer
    g = torch.Generator(device="cuda").manual_seed(31)
    B, S, E, X, M = 2, 64, 128, 8, 256
    ts = [torch.randn(*sh, generator=g, device="cuda") * sc
          for sh, sc in (((B, S, E), 1.0), ((E, X), 0.3), ((X, E, M), 0.1),
                         ((X, E, M), 0.1), ((X, M, E), 0.1))]
    sparse = moe_layer(*ts, k=2, capacity_factor=X / 2)[0]
    dense = moe_layer(*ts, k=2, capacity_factor=0.0)[0]
    return (sparse - dense).abs().max().item()


class SameRouting:
    """Record the expert choices (top-k indices) of every routing call of
    one forward and backward (full remat calls each layer's routing again
    in the backward), then replay them, in order, in later runs: each
    takes its own router probabilities but the recorded choices.  Two
    paths that differ only in their attention rounding then make the same
    discrete top-k choices and drops, and what differs is the attention
    kernels' alone; free, one token whose top two experts are nearly tied
    can flip and move its gradient by its whole MLP output.

    ``choices``: a record made elsewhere (another process's, on the CPU);
    ``local``: what of a recorded whole-batch choice this process's tokens
    are (a rank of a sharded step replaying one card's record)."""

    def __init__(self, choices=None, local=None):
        import importlib
        self.moe = importlib.import_module("ray_tpu_torch.ops.moe")
        self.real = self.moe._routing
        self.choices = [] if choices is None else choices
        self.local = local or (lambda idx: idx)

    def _record(self, *args):
        info, topv = self.real(*args)
        self.choices.append(info.expert_index)
        return info, topv

    def _replay(self, x, router_w, k, noise, gen):
        info, _ = self.real(x, router_w, k, noise, gen)
        idx = self.local(self.choices[self.at]).to(x.device)
        self.at += 1
        topv = info.router_probs.gather(-1, idx)
        topv = topv / topv.sum(-1, keepdim=True)
        combine = info.router_probs.new_zeros(
            info.router_probs.shape).scatter(-1, idx, topv)
        return self.moe.RoutingInfo(combine, info.router_probs, idx), topv

    def run(self, fn, record: bool):
        """fn() with the routing recorded (record) or replayed."""
        self.at = 0
        self.moe._routing = self._record if record else self._replay
        try:
            out = fn()
        finally:
            self.moe._routing = self.real
        check(record or self.at == len(self.choices),
              f"routing replayed {self.at} of {len(self.choices)} calls")
        return out


def _moe_compare(cfg, params, small):
    """train_moe's B=2 comparison: loss, grad norm and every layer's
    attention gradients, the flash kernels against the plain attention
    with the same expert choices (SameRouting), then each of
    PLANTED_FAULTS in flash_bwd's output the same way; and, reported
    beside them, the plain path with its own choices."""
    import importlib
    attn_mod = importlib.import_module("ray_tpu_torch.ops.attention")
    plain_cfg = cfg.replace(attention_impl="reference")
    routing = SameRouting()
    got = routing.run(lambda: _loss_and_grads(cfg, params, small), True)
    want = routing.run(lambda: _loss_and_grads(plain_cfg, params, small),
                       False)
    free = _loss_and_grads(plain_cfg, params, small)
    planted = {}
    real = attn_mod.flash_bwd
    for fault, scales in PLANTED_FAULTS.items():
        def faulty(*args, _scales=scales, **kw):
            return tuple(g * s for g, s in zip(real(*args, **kw), _scales))
        attn_mod.flash_bwd = faulty
        try:
            planted[fault] = _worst_layer_err(routing.run(
                lambda: _loss_and_grads(cfg, params, small), False)[2],
                want[2])
        finally:
            attn_mod.flash_bwd = real
    worst, where = _worst_layer_err(got[2], want[2])
    return {"rel_err": {"loss": abs(got[0] - want[0]) / abs(want[0]),
                        "grad_norm": abs(got[1] - want[1]) / abs(want[1]),
                        "attn_grad": worst},
            "attn_grad_worst_at": where,
            "planted_faults_attn_grad": planted,
            "free_routing": {
                "loss": abs(got[0] - free[0]) / abs(free[0]),
                "grad_norm": abs(got[1] - free[1]) / abs(free[1]),
                "attn_grad": _worst_layer_err(got[2], free[2])},
            "tol": TOL_TRAIN_BF16}


def phase_train_moe(smi):
    """MOE_CFG through make_lm_train_step on one card: 2 warm-up steps,
    then 3 timed steps (the main path), one profiled step, then loss,
    grad norm and every layer's attention gradients at B 2 against the
    plain attention path with the same expert choices (TOL_TRAIN_BF16,
    _moe_compare), and the fp32 dispatch check."""
    import torch
    from ray_tpu_torch.models.llama import LlamaConfig, num_params
    from ray_tpu_torch.ops.moe import capacity
    from ray_tpu_torch.parallel import build_mesh, make_lm_train_step
    cfg = LlamaConfig(**MOE_CFG, dtype=torch.bfloat16, remat=True,
                      attention_impl="flash")
    init_fn, step_fn, place = make_lm_train_step(
        cfg, build_mesh(), learning_rate=TRAIN_LR,
        param_dtype=torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    params, opt = init_fn(torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(14)
    batch = place({"tokens": rng.integers(
        0, cfg.vocab_size, (MOE_BATCH, TRAIN_SEQ), dtype=np.int32)})
    losses = []
    for _ in range(2):
        params, opt, m = step_fn(params, opt, batch)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    # -- the main path: launch counts read from this window only.
    _reset_launches()
    steps = 3
    t0 = time.perf_counter()
    for _ in range(steps):
        params, opt, m = step_fn(params, opt, batch)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated()
    # -- end of the main path.
    losses = [x.item() for x in losses]
    step_s = wall / steps
    tok_s = MOE_BATCH * TRAIN_SEQ / step_s
    busy_ms, top, kinds = _device_time(lambda: step_fn(params, opt, batch),
                                       top=12)
    compare = _moe_compare(cfg, params, {"tokens": batch["tokens"][:2]})
    errs = compare["rel_err"]
    dispatch_err = _moe_dispatch_check()
    n_active = active_params(cfg)
    res = {"phase": "train_moe", "card": smi,
           "config": "llama_1b widths and depth, 8 experts, top-2, "
                     "capacity factor 1.25",
           "num_params": num_params(cfg), "active_params": n_active,
           "capacity_slots_per_expert": capacity(
               MOE_BATCH * TRAIN_SEQ, cfg.moe_top_k,
               cfg.moe_capacity_factor, cfg.num_experts),
           "batch": [MOE_BATCH, TRAIN_SEQ], "remat": True,
           "param_dtype": "bfloat16", "lr": TRAIN_LR, "steps_timed": steps,
           "step_ms": step_s * 1e3, "tokens_per_s": tok_s,
           "mfu_active": 6.0 * n_active * tok_s / PEAK_BF16_FLOPS,
           "mfu_formula": "6 * active_params * tokens_per_s / 989e12",
           "peak_mem_gb": peak / 2**30, "losses": losses,
           "launches_per_step": {k: v / steps for k, v in launches.items()},
           "profile_one_step": {
               "device_busy_ms": busy_ms,
               "device_idle_share": 1 - busy_ms / (step_s * 1e3),
               "device_ms_by_kind": kinds,
               "top_kernels_ms": [[name[:48], round(us / 1e3, 3), n]
                                  for name, (us, n) in top]},
           "kernel_vs_plain_B2": compare,
           "sorted_no_drops_vs_dense_fp32_max_abs": dispatch_err}
    emit(res)
    check_share(res["profile_one_step"]["device_idle_share"], "train_moe")
    want_l = {"flash_fwd": 2 * cfg.layers, "flash_bwd_dq": cfg.layers,
              "flash_bwd_dkv": cfg.layers}
    check({k: res["launches_per_step"][k] for k in want_l} == want_l,
          f"train_moe launches {launches}")
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"train_moe losses {losses}")
    check(all(errs[k] <= TOL_TRAIN_BF16[k] for k in errs),
          f"train_moe B=2 kernel vs plain {errs}")
    check(all(e > TOL_TRAIN_BF16["attn_grad"] for e, _ in
              compare["planted_faults_attn_grad"].values()),
          f"a planted backward fault passes train_moe's check: {compare}")
    check(dispatch_err <= TOL["float32"],
          f"sorted dispatch vs dense {dispatch_err}")
    return {k: launches[k] for k in want_l}


# ------------------------------------------------------------------- RL
#
# ray_tpu_torch.rl runs no kernel of its own (ray_tpu/rl reaches no Pallas
# kernel): these phases hold its algorithms on the card to the same
# algorithms on the CPU, count its host syncs, and time its training.

RL_TOL = 1e-5      # card vs CPU, TF32 off: relative to the largest
#                    magnitude in each compared tree
RL_METRIC_FLOOR = 0.01
RL_ALGOS = ("PPO", "DQN", "SAC", "TQC", "IMPALA", "APPO", "BC", "MARWIL",
            "CQL", "IQL", "MultiAgentPPO")
RL_PPO_ITERS = 5
RL_ROLLOUT_N, RL_ROLLOUT_T = 4096, 128


def _rl_tree_err(got, want) -> float:
    """max |got - want| over the tree / the largest |want| in it."""
    from ray_tpu_torch._tree import tree_leaves
    g = [np.asarray(x, np.float64) for x in tree_leaves(got)]
    w = [np.asarray(x, np.float64) for x in tree_leaves(want)]
    check(len(g) == len(w) and all(a.shape == b.shape for a, b in zip(g, w)),
          "rl trees differ in structure")
    scale = max(max(float(np.abs(b).max()) for b in w), 1e-12)
    return max(float(np.abs(a - b).max()) for a, b in zip(g, w)) / scale


def _rl_rollout(seed, T, N, obs_dim, n_act):
    r = np.random.default_rng(seed)
    dones = r.random((T, N)) < 0.3
    terms = dones & (r.random((T, N)) < 0.7)
    return {"obs": r.normal(size=(T, N, obs_dim)).astype(np.float32),
            "actions": r.integers(0, n_act, (T, N)).astype(np.int32),
            "logp": np.log(r.uniform(0.1, 0.5, (T, N))).astype(np.float32),
            "values": r.normal(size=(T, N)).astype(np.float32),
            "rewards": r.normal(size=(T, N)).astype(np.float32),
            "dones": dones, "terminateds": terms,
            "bootstrap_values": np.where(dones & ~terms, r.normal(
                size=(T, N)), 0).astype(np.float32),
            "last_values": r.normal(size=N).astype(np.float32)}


def _rl_offline_data(tmp: str) -> str:
    from ray_tpu_torch.rl import collect_from_env

    def behavior(obs, r):
        return int(r.integers(4)) if r.random() < 0.3 \
            else int(np.argmax(obs))
    return collect_from_env("StatelessGuess", behavior, 2000,
                            os.path.join(tmp, "guess.npz"), seed=0)


def rl_update(name: str, device: str, data_path: str, weights=None):
    """One update of algorithm ``name`` (``RL_ALGOS``) on ``device`` from
    ``weights`` (a numpy tree; None: the algorithm's own seeded init) and
    a batch from numpy seeds: PPO and MultiAgentPPO a whole training_step
    on a fixed rollout, the others their one-update method on a fixed
    batch (SAC/TQC with fixed normal draws).  Returns (the weights before
    as numpy, metrics, the weights after as numpy)."""
    import ray_tpu_torch.rl as rl
    from ray_tpu_torch.rl._transfer import to_numpy
    r = np.random.default_rng(1)
    B = 64
    disc = lambda: {"obs": r.normal(size=(B, 4)).astype(np.float32),
                    "actions": r.integers(0, 4, B).astype(np.int32)}
    trans = lambda: dict(disc(), rewards=r.normal(size=B).astype(
        np.float32), next_obs=r.normal(size=(B, 4)).astype(np.float32),
        terminateds=(r.random(B) < 0.2).astype(np.float32))
    base = lambda c: c.debugging(seed=0).training(lr=1e-3).resources(
        device=device)
    if name == "PPO":
        algo = base(rl.PPOConfig().environment(
            lambda: rl.StatelessGuess(4)).env_runners(
                rollout_fragment_length=32)).build_algo()
    elif name == "DQN":
        algo = base(rl.DQNConfig().environment(
            lambda: rl.StatelessGuess(4))).build_algo()
    elif name in ("SAC", "TQC"):
        algo = base(getattr(rl, name + "Config")().environment(
            "Pendulum-v1")).build_algo()
    elif name in ("IMPALA", "APPO"):
        algo = base(getattr(rl, name + "Config")().environment(
            lambda: rl.StatelessGuess(4)).env_runners(
                num_env_runners=0)).build_algo()
    elif name == "MultiAgentPPO":
        algo = base(rl.MultiAgentPPOConfig().environment(
            lambda: rl.MultiGuess(seed=0)).multi_agent(
                policy_mapping_fn=lambda aid: aid)).build_algo()
    else:
        algo = base(getattr(rl, name + "Config")().environment(
            "StatelessGuess").offline_data(input_path=data_path)
        ).build_algo()
    if weights is not None:
        algo.set_weights(weights)
    before = to_numpy(algo.get_weights())
    if name == "PPO":
        ro = _rl_rollout(2, 32, 4, 4, 4)
        algo.env_runner_group.sample = lambda n: [ro]
        m = algo.training_step()["learner"]
    elif name == "MultiAgentPPO":
        per = {pid: {k: v.reshape(32, *v.shape[2:])
                     for k, v in _rl_rollout(3 + i, 32, 1, 4, 4).items()
                     if k not in ("bootstrap_values", "last_values")}
               for i, pid in enumerate(("a0", "a1"))}
        algo.runner.sample = lambda n: per
        m = algo.training_step()["learner"]
    elif name == "DQN":
        m = algo._update(trans())
    elif name in ("SAC", "TQC"):
        b = {"obs": r.normal(size=(B, 3)).astype(np.float32),
             "actions": r.uniform(-2, 2, (B, 1)).astype(np.float32),
             "rewards": r.normal(size=B).astype(np.float32),
             "next_obs": r.normal(size=(B, 3)).astype(np.float32),
             "terminateds": (r.random(B) < 0.2).astype(np.float32)}
        eps = tuple(r.normal(size=(B, 1)).astype(np.float32)
                    for _ in range(2))
        from ray_tpu_torch.rl._transfer import fetch_metrics
        m = fetch_metrics(algo._update(b, eps=eps))
    elif name in ("IMPALA", "APPO"):
        m = algo._correct_and_update(_rl_rollout(4, 32, 4, 4, 4))
    elif name in ("CQL", "IQL"):
        m = algo._update(trans())
    else:
        m = algo.learner.update(algo._prepare_batch(dict(
            disc(), returns_to_go=r.normal(size=B).astype(np.float32))))
    return before, m, to_numpy(algo.get_weights())


def rl_card_vs_cpu(name: str, data_path: str, device: str = "cuda"):
    """``rl_update`` of ``name`` on the card and on the CPU from the same
    weights: (max relative error of the params, of the metrics).  A
    metric is held relative to max(|value|, RL_METRIC_FLOOR): some are
    means of signed values that cancel (TQC's z_mean: ~4e-4 from
    quantiles of ~0.1)."""
    w0, m_cpu, w_cpu = rl_update(name, "cpu", data_path)
    _w, m_gpu, w_gpu = rl_update(name, device, data_path, weights=w0)
    flat = lambda m: {f"{k}/{j}" if isinstance(v, dict) else k: x
                      for k, v in m.items()
                      for j, x in (v.items() if isinstance(v, dict)
                                   else [(None, v)])}
    mc, mg = flat(m_cpu), flat(m_gpu)
    check(sorted(mc) == sorted(mg), f"rl {name}: metric names differ")
    metric_err = max(abs(mg[k] - mc[k]) / max(abs(mc[k]), RL_METRIC_FLOOR)
                     for k in mc)
    return _rl_tree_err(w_gpu, w_cpu), metric_err


def rl_bc_dataset_vs_npz(data_path: str, device: str = "cuda"):
    """A BC training step (3 updates) on ``device`` from the ``.npz``
    input and from a ``Dataset`` of the same columns (``from_numpy``: no
    pyarrow), from the same seed: (max abs difference of the weights, of
    the metrics); both 0 when the Dataset feeds the same rows."""
    import ray_tpu_torch.rl as rl
    from ray_tpu_torch import data as rdata
    from ray_tpu_torch.rl._transfer import to_numpy
    from ray_tpu_torch._tree import tree_leaves
    with np.load(data_path) as z:
        cols = {k: z[k] for k in z.files}
    out = []
    for src in (data_path, rdata.from_numpy(cols, parallelism=4)):
        algo = (rl.BCConfig().environment("StatelessGuess")
                .offline_data(input_path=src, updates_per_iteration=3)
                .training(lr=1e-3).debugging(seed=0)
                .resources(device=device)).build_algo()
        m = algo.training_step()["learner"]
        out.append((tree_leaves(to_numpy(algo.get_weights())), m))
    (w_npz, m_npz), (w_ds, m_ds) = out
    check(sorted(m_npz) == sorted(m_ds), "rl BC: metric names differ")
    w_err = max(float(np.abs(np.asarray(a, np.float64)
                             - np.asarray(b, np.float64)).max())
                for a, b in zip(w_ds, w_npz))
    m_err = max(abs(float(m_ds[k]) - float(m_npz[k])) for k in m_npz)
    return w_err, m_err


def rl_models_card_vs_cpu(device: str = "cuda"):
    """The CNN forward at 84x84x4 and the GRU forward_train at T 32, on
    the card and on the CPU from the same weights: max relative errors."""
    import torch
    from ray_tpu_torch.rl import (CNNPolicyModule, CNNPolicySpec,
                                  GRUPolicyModule, RecurrentPolicySpec)
    from ray_tpu_torch.rl._transfer import to_device, to_numpy
    r = np.random.default_rng(5)
    out = {}
    cnn = CNNPolicyModule(CNNPolicySpec((84, 84, 4), 6))
    gru = GRUPolicyModule(RecurrentPolicySpec(8, 4, hidden=64))
    p_cnn = cnn.init(torch.Generator().manual_seed(0))
    p_gru = gru.init(torch.Generator().manual_seed(1))
    obs = r.uniform(size=(32, 84, 84, 4)).astype(np.float32)
    seq = r.normal(size=(16, 32, 8)).astype(np.float32)
    h0 = r.normal(size=(16, 64)).astype(np.float32)
    resets = r.random((16, 32)) < 0.1
    res = {}
    for dev in ("cpu", device):
        d = torch.device(dev)
        with torch.no_grad():
            c = cnn.forward_train(to_device(p_cnn, d), to_device(obs, d))
            g = gru.forward_train(to_device(p_gru, d), to_device(seq, d),
                                  to_device(h0, d), to_device(resets, d))
        res[dev] = to_numpy({"cnn": c, "gru": g})
    for k in ("cnn", "gru"):
        out[k] = _rl_tree_err(res[device][k], res["cpu"][k])
    return out


def rl_cartpole_card_vs_numpy(n: int = 4096, device: str = "cuda"):
    """``TorchCartPoleVector.step`` on the card from 4096 states against
    numpy ``CartPole.step`` from the same states: the number of lanes
    outside rtol 1e-5 / atol 1e-6 (the JAX test's), and the flags'
    mismatches."""
    import torch
    from ray_tpu_torch.rl import CartPole, TorchCartPoleVector
    vec = TorchCartPoleVector(n, seed=3, device=device)
    states = vec.reset().cpu().numpy().copy()
    actions = np.arange(n) % 2
    nxt, rew, term, trunc = vec.step(torch.from_numpy(actions).to(device))
    nxt, term = nxt.cpu().numpy(), term.cpu().numpy()
    bad_state = bad_flag = 0
    for i in range(n):
        py = CartPole()
        py._state = states[i].astype(np.float64)
        want, _r, te, _tr, _ = py.step(int(actions[i]))
        bad_flag += int(bool(term[i]) != te)
        if not te and not np.allclose(nxt[i], want, rtol=1e-5, atol=1e-6):
            bad_state += 1
    return {"lanes": n, "state_mismatches": bad_state,
            "terminated_mismatches": bad_flag,
            "rewards_all_one": bool((rew == 1).all().item())}


def phase_rl_exact(smi):
    """Each algorithm's update on the card against the same update on the
    CPU (TF32 off for matmuls and cuDNN); the CNN and GRU forwards; the
    device CartPole against the numpy env.  A mismatch fails the run."""
    import tempfile
    import torch
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            data = _rl_offline_data(tmp)
            algos = {}
            for name in RL_ALGOS:
                p_err, m_err = rl_card_vs_cpu(name, data)
                algos[name] = {"params_rel_err": p_err,
                               "metrics_rel_err": m_err}
            bc_dataset = dict(zip(("params_abs_diff", "metrics_abs_diff"),
                                  rl_bc_dataset_vs_npz(data)))
        models = rl_models_card_vs_cpu()
        cartpole = rl_cartpole_card_vs_numpy()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    emit({"phase": "rl_exact", "card": smi, "tf32": False, "tol": RL_TOL,
          "algos": algos, "bc_dataset_vs_npz": bc_dataset,
          "models_rel_err": models, "cartpole": cartpole,
          "seconds": time.perf_counter() - t0})
    bad = {k: v for k, v in algos.items()
           if v["params_rel_err"] > RL_TOL or v["metrics_rel_err"] > RL_TOL}
    check(not bad, f"rl_exact: card and CPU updates differ: {bad}")
    check(bc_dataset == {"params_abs_diff": 0.0, "metrics_abs_diff": 0.0},
          f"rl_exact: BC from a Dataset differs from the .npz's: "
          f"{bc_dataset}")
    check(all(v <= RL_TOL for v in models.values()),
          f"rl_exact: CNN/GRU card vs CPU {models}")
    check(cartpole["state_mismatches"] == 0
          and cartpole["terminated_mismatches"] == 0
          and cartpole["rewards_all_one"], f"rl_exact cartpole {cartpole}")


def _rl_syncs(fn):
    """(fn's result, the host syncs torch's sync debug mode reports while
    it runs)."""
    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, len(_syncs(caught))


def _rl_profile(run):
    """One call of ``run`` under torch.profiler: its wall ms, the card's
    busy ms (kernel time summed), the kernels launched and the idle
    share 1 - busy / wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy_us, launches = 0.0, 0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0:
            busy_us += us
            launches += ev.count
    idle = 1 - busy_us / 1e3 / wall
    check_share(idle, "an RL profile window")
    return {"wall_ms": wall, "busy_ms": busy_us / 1e3,
            "kernels": launches, "idle_share": idle}


def _rl_sample_parts(runner, steps):
    """Where a sample's time goes, per env step (ms): the forward with
    its one readback (``_act``), the numpy envs' step, and the rest (the
    pinned upload, buffers, bookkeeping); then the forward alone, enqueued
    back to back with no readback, which leaves the round trip."""
    import torch
    import ray_tpu_torch.rl.env_runner as er
    parts = {"act": 0.0, "env_step": 0.0}

    def timed(part, fn):
        def run(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                parts[part] += (time.perf_counter() - t) * 1e3
        return run

    runner._act = timed("act", runner._act)
    runner.vec.step = timed("env_step", runner.vec.step)
    try:
        t0 = time.perf_counter()
        runner.sample(steps)
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        del runner._act, runner.vec.step
    obs = er.to_device(runner._obs, runner.device)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            runner.module.forward_exploration(runner.params, obs,
                                              runner._gen)
        enqueue = (time.perf_counter() - t0) * 1e3 / steps
        torch.cuda.synchronize()
    per = {k: v / steps for k, v in parts.items()}
    per["other"] = wall / steps - sum(per.values())
    per["forward_enqueue_only"] = enqueue
    per["readback_wait"] = per["act"] - enqueue
    return per


def _rl_ppo_default(smi, device="cuda"):
    """PPO at the repo's default config on CartPole (4 envs x 128 steps,
    MLP 64x64, 4 epochs of 128-row minibatches), RL_PPO_ITERS iterations
    of build().train(), timed by part; then the host syncs of one sample
    and of one learner update."""
    import ray_tpu_torch.rl.ppo as ppo_mod
    from ray_tpu_torch.rl import PPOConfig
    algo = PPOConfig().environment("CartPole-v1").resources(
        device=device).build()
    parts = {"sample": 0.0, "gae": 0.0, "learner": 0.0}

    def timed(part, fn):
        def run(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                parts[part] += time.perf_counter() - t
        return run

    runner_group, learner_group = algo.env_runner_group, algo.learner_group
    runner_group.sample = timed("sample", runner_group.sample)
    learner_group.update = timed("learner", learner_group.update)
    real_gae = ppo_mod.compute_gae
    ppo_mod.compute_gae = timed("gae", real_gae)
    try:
        algo.train()                         # warm-up iteration
        for k in parts:
            parts[k] = 0.0
        t0 = time.perf_counter()
        for _ in range(RL_PPO_ITERS):
            res = algo.train()
        total = time.perf_counter() - t0
    finally:
        ppo_mod.compute_gae = real_gae
        del runner_group.sample, learner_group.update
    cfg = algo.config
    steps = cfg.rollout_fragment_length * cfg.num_envs_per_runner
    runner = runner_group.local
    batch, sample_syncs = _rl_syncs(lambda: runner.sample(
        cfg.rollout_fragment_length))
    mb = {k: v.reshape(-1, *v.shape[2:])[:cfg.minibatch_size]
          for k, v in batch.items() if k in ("obs", "actions")}
    n = len(mb["actions"])
    mb.update(logp_old=batch["logp"].reshape(-1)[:n],
              advantages=np.ones(n, np.float32),
              value_targets=np.zeros(n, np.float32),
              **ppo_mod.ppo_consts(cfg))
    _m, update_syncs = _rl_syncs(lambda: learner_group.update(mb))
    check(sample_syncs == cfg.rollout_fragment_length + 1,
          f"rl_train: {sample_syncs} host syncs in a sample of "
          f"{cfg.rollout_fragment_length} steps (want one a step and one "
          f"for the bootstrap values)")
    check(update_syncs == 1,
          f"rl_train: {update_syncs} host syncs in one learner update")
    sample_parts = _rl_sample_parts(runner, cfg.rollout_fragment_length)
    sample_prof = _rl_profile(lambda: runner.sample(
        cfg.rollout_fragment_length))
    update_prof = _rl_profile(lambda: learner_group.update(mb))
    updates = cfg.num_epochs * (steps // cfg.minibatch_size)
    per = {k: v / RL_PPO_ITERS for k, v in parts.items()}
    return {"config": {"env": "CartPole-v1",
                       "num_envs": cfg.num_envs_per_runner,
                       "rollout_fragment_length": cfg.rollout_fragment_length,
                       "hidden": list(cfg.module_hidden),
                       "num_epochs": cfg.num_epochs,
                       "minibatch_size": cfg.minibatch_size},
            "iterations": RL_PPO_ITERS, "s_per_iter": total / RL_PPO_ITERS,
            "s_per_iter_by_part": per,
            "s_per_iter_other": total / RL_PPO_ITERS - sum(per.values()),
            "env_steps_per_iter": steps, "updates_per_iter": updates,
            "env_steps_per_s": steps * RL_PPO_ITERS / total,
            "sample_env_steps_per_s": steps / per["sample"],
            "host_syncs_per_sample": sample_syncs,
            "host_syncs_per_env_step": sample_syncs
            / cfg.rollout_fragment_length,
            "host_syncs_per_update": update_syncs,
            "sample_ms_per_env_step": sample_parts,
            "sample_profile": sample_prof, "update_profile": update_prof,
            "episode_return_mean":
                res["env_runners"]["episode_return_mean"],
            "card": smi}


def _rl_device_rollout(smi, device="cuda"):
    """TorchCartPoleVector.rollout at N x T with the PPO module's
    exploration forward as the policy: env steps/s and the host syncs
    inside (none: nothing is read back until the caller reads)."""
    import torch
    from ray_tpu_torch.rl import (DiscretePolicyModule, RLModuleSpec,
                                  TorchCartPoleVector)
    module = DiscretePolicyModule(RLModuleSpec(4, 2))
    params = module.init(torch.Generator(device=device).manual_seed(0))
    vec = TorchCartPoleVector(RL_ROLLOUT_N, seed=0, device=device)
    vec.reset()
    gen = torch.Generator(device=device).manual_seed(1)
    policy = lambda p, obs, g: module.forward_exploration(p, obs, g)[0]
    vec.rollout(params, policy, 8, gen)          # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    traj, syncs = _rl_syncs(lambda: vec.rollout(params, policy,
                                                RL_ROLLOUT_T, gen))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    prof = _rl_profile(lambda: vec.rollout(params, policy, RL_ROLLOUT_T,
                                           gen))
    rew = float(traj[2].sum().item())
    check(syncs == 0, f"rl_train: {syncs} host syncs inside rollout")
    check(rew == RL_ROLLOUT_N * RL_ROLLOUT_T and tuple(traj[0].shape) == (
        RL_ROLLOUT_T, RL_ROLLOUT_N, 4), "rl_train: rollout output")
    return {"num_envs": RL_ROLLOUT_N, "steps": RL_ROLLOUT_T,
            "seconds": secs,
            "env_steps_per_s": RL_ROLLOUT_N * RL_ROLLOUT_T / secs,
            "host_syncs_inside": syncs, "profile": prof,
            "kernels_per_step": prof["kernels"] / RL_ROLLOUT_T,
            "episodes_ended": int(traj[3].sum().item()), "card": smi}


def _rl_others(smi, data_path, device="cuda"):
    """One train() of every other algorithm at its JAX default widths
    (MLP 64x64, default batch sizes; the offline ones on 2,000
    StatelessGuess transitions).  The off-policy ones start learning
    after 64 steps instead of 500, so their one iteration of 128 env
    steps includes updates.  Each runs twice; the second is timed."""
    import ray_tpu_torch.rl as rl
    cfgs = {
        "DQN": rl.DQNConfig().environment("CartPole-v1").training(
            learning_starts=64),
        "SAC": rl.SACConfig().environment("Pendulum-v1").training(
            learning_starts=64),
        "TQC": rl.TQCConfig().environment("Pendulum-v1").training(
            learning_starts=64),
        "IMPALA": rl.IMPALAConfig().environment("CartPole-v1").env_runners(
            num_env_runners=0),
        "APPO": rl.APPOConfig().environment("CartPole-v1").env_runners(
            num_env_runners=0),
        "BC": rl.BCConfig().environment("StatelessGuess").offline_data(
            input_path=data_path),
        "MARWIL": rl.MARWILConfig().environment(
            "StatelessGuess").offline_data(input_path=data_path),
        "CQL": rl.CQLConfig().environment("StatelessGuess").offline_data(
            input_path=data_path),
        "IQL": rl.IQLConfig().environment("StatelessGuess").offline_data(
            input_path=data_path),
        "MultiAgentPPO": rl.MultiAgentPPOConfig().environment(
            lambda: rl.MultiGuess(seed=0)).multi_agent(
                policy_mapping_fn=lambda aid: aid),
    }
    rows = {}
    for name, cfg in cfgs.items():
        algo = cfg.resources(device=device).build_algo()
        t0 = time.perf_counter()
        algo.train()
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = algo.train()
        rows[name] = {"s_first_iter": first,
                      "s_per_iter": time.perf_counter() - t0,
                      "learner": sorted(res.get("learner", {}))}
        check(rows[name]["learner"], f"rl_train: {name} made no update")
    return rows


def phase_rl_train(smi):
    """PPO at the default config through build().train(); the device
    CartPole rollout; one train() of every other algorithm.  Torch's TF32
    defaults (matmul off, cuDNN on)."""
    import tempfile
    import torch
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    t0 = time.perf_counter()
    try:
        ppo = _rl_ppo_default(smi)
        rollout = _rl_device_rollout(smi)
        with tempfile.TemporaryDirectory() as tmp:
            others = _rl_others(smi, _rl_offline_data(tmp))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    emit({"phase": "rl_train", "card": smi, "ppo": ppo,
          "device_rollout": rollout, "others": others,
          "seconds": time.perf_counter() - t0})


# -- the process tier: serve deployment, remote RL, collective groups ---------

#: serve_deployment: 8 requests of 256 prompt + 32 new tokens through the
#: handle, one of 64 + 24 through the stream (llama_1b, bf16, seed 0).
DEPLOY_REQUESTS, DEPLOY_PROMPT, DEPLOY_NEW = 8, 256, 32
DEPLOY_STREAM = (64, 24)
DEPLOY_OPTS = dict(max_slots=16, page_size=16, prefill_buckets=(64, 256),
                   num_pages=16 * 20 + 1)


def deployment_params(seed: int, device: str = "cuda",
                      model: str = "llama_1b"):
    """The deployment's ``build_params`` (module level: the replica process
    imports it from this file): ``model`` (llama_1b: full width and depth)
    in bf16 from a seeded generator on ``device``."""
    import torch
    from ray_tpu_torch.models import llama
    cfg = getattr(llama, model)()
    gen = torch.Generator(device=device).manual_seed(seed)
    return llama.init_params(cfg, gen, param_dtype=torch.bfloat16,
                             device=device), cfg


class SmokeLLMServer:
    """The deployment's class in this phase: ``build_llm_deployment``'s
    ``LLMServer``, which it wraps and to which it hands every call, plus
    the replica's own kernel launch counts (this process's counters see
    nothing of another process).  Module level: the replica imports it
    from this file."""

    def __init__(self, build_params, engine_options=None):
        from ray_tpu_torch.llm import LLMServer
        self.server = LLMServer(build_params, engine_options)

    def __call__(self, body):
        return self.server(body)

    def __getattr__(self, name):
        return getattr(self.server, name)

    def reset_launches(self) -> bool:
        _reset_launches()
        return True

    def read_launches(self):
        return _read_launches()

    def pid(self) -> int:
        return os.getpid()


def _deployment_bodies(vocab: int):
    rng = np.random.default_rng(11)
    bodies = [{"prompt_tokens": rng.integers(0, vocab, DEPLOY_PROMPT).tolist(),
               "max_tokens": DEPLOY_NEW} for _ in range(DEPLOY_REQUESTS)]
    stream = {"prompt_tokens": rng.integers(0, vocab,
                                            DEPLOY_STREAM[0]).tolist(),
              "max_tokens": DEPLOY_STREAM[1]}
    return bodies, stream


def _serve_all(call, stream, bodies, stream_body):
    """The requests at once (one thread each) and the stream in this
    thread: (results, streamed items, stream TTFT s, wall s)."""
    results = [None] * len(bodies)

    def one(i):
        results[i] = call(bodies[i])

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(bodies))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    items, ttft = [], None
    for item in stream(stream_body):
        if ttft is None:
            ttft = time.perf_counter() - t0
        items.append(item)
    for t in threads:
        t.join(timeout=600)
    check(not any(t.is_alive() for t in threads), "requests did not return")
    return results, items, ttft, time.perf_counter() - t0


def phase_serve_deployment(smi, device: str = "cuda",
                           model: str = "llama_1b"):
    """build_llm_deployment at llama_1b in one replica process on the card,
    through serve.run and the handle (remote and the stream), against the
    in-process LLMServer on the same weights: equal greedy tokens.  The
    kernels' launches are counted inside the replica, zeroed just before
    the requests and read just after.  (``device="cpu"`` with
    ``llama_tiny`` rehearses the phase where there is no card.)"""
    import functools

    import torch
    from ray_tpu_torch import _actor, serve
    from ray_tpu_torch.llm import LLMServer, build_llm_deployment
    build = functools.partial(deployment_params, 0, device, model)
    opts = dict(DEPLOY_OPTS, device=device)
    bodies, stream_body = _deployment_bodies(build()[1].vocab_size)
    # The reference: the same requests through the in-process server.
    server = LLMServer(build, opts)
    try:
        server(dict(bodies[0], max_tokens=2))          # warm-up
        ref, ref_items, ref_ttft, ref_wall = _serve_all(
            server, server.stream, bodies, stream_body)
    finally:
        server.close()
    del server
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    app = build_llm_deployment(build, name=model, engine_options=opts)
    # The user's entry point, its LLMServer wrapped by the class that
    # reports the replica's launch counts.
    check(app.deployment.cls_or_fn is LLMServer, "not LLMServer's")
    app = serve.Application(app.deployment.options(cls_or_fn=SmokeLLMServer))
    t0 = time.perf_counter()
    handle = serve.run(app)
    start_s = time.perf_counter() - t0
    try:
        _actor.get(handle.remote(dict(bodies[0], max_tokens=2)), timeout=300)
        replica = handle.options(method_name="reset_launches")
        _actor.get(replica.remote(), timeout=60)
        # -- the main path: launches counted in the replica.
        streamer = handle.options(stream=True, method_name="stream")
        got, items, ttft, wall = _serve_all(
            lambda b: _actor.get(handle.remote(b), timeout=600),
            lambda b: (_actor.get(r, timeout=600)
                       for r in streamer.remote(b)),
            bodies, stream_body)
        launches = _actor.get(handle.options(
            method_name="read_launches").remote(), timeout=60)
        # -- end of the main path.
        if device == "cuda":
            _profile_serving(smi, handle, bodies, _actor.get(
                handle.options(method_name="pid").remote(), timeout=60))
    finally:
        serve.shutdown()
    tokens = [r["output_tokens"] for r in got]
    ref_tokens = [r["output_tokens"] for r in ref]
    streamed = [it["token"] for it in items if "token" in it]
    ref_streamed = [it["token"] for it in ref_items if "token" in it]
    new = DEPLOY_REQUESTS * DEPLOY_NEW + DEPLOY_STREAM[1]
    res = {"phase": "serve_deployment", "model": model, "card": smi,
           "replicas": 1, "requests": DEPLOY_REQUESTS,
           "prompt_tokens": DEPLOY_PROMPT, "new_tokens": DEPLOY_NEW,
           "stream": list(DEPLOY_STREAM), "start_s": start_s,
           "wall_s": wall, "gen_tok_s": new / wall, "ttft_s": ttft,
           "in_process": {"wall_s": ref_wall, "gen_tok_s": new / ref_wall,
                          "ttft_s": ref_ttft},
           "tokens_equal": tokens == ref_tokens,
           "stream_equal": streamed == ref_streamed,
           "launches": {k: launches[k] for k in ("flash_fwd",
                                                 "paged_decode")}}
    emit(res)
    check(all(len(t) == DEPLOY_NEW for t in tokens)
          and len(streamed) == DEPLOY_STREAM[1],
          f"serve_deployment: short outputs {[len(t) for t in tokens]}")
    check(tokens == ref_tokens and streamed == ref_streamed,
          "serve_deployment: the deployment's greedy tokens differ from "
          "the in-process server's on the same weights")
    check(device == "cpu" or (res["launches"]["flash_fwd"] > 0
                              and res["launches"]["paged_decode"] > 0),
          f"serve_deployment: kernels not launched in the replica "
          f"{res['launches']}")
    return res["launches"]


# ------------------------------------------- the process tier's serving

#: handoff_ipc: a llama_1b handoff of 960 prompt tokens (its K/V trimmed to
#: 1,024 rows: 2 x 16 layers x 1,024 x 8 heads x 128 x 2 B = 64 MiB) from
#: this process to a replica process on the same card, which decodes
#: IPC_NEW tokens from it.
IPC_PROMPT, IPC_NEW = 960, 8
#: fleet_remote's exactness requests: (prompt length, new tokens), sent one
#: at a time; the last repeats the first (a full prefix hit).
REMOTE_EXACT = ((960, 16), (500, 16), (64, 16), (960, 16))
#: serve_controller: the burst's concurrent requests (256-token prompts,
#: AUTO_NEW new tokens: ~3 s of decode on one replica), and the
#: deployment's autoscaling: 16 in flight over a target of 4 a replica
#: asks for 4 replicas, clamped to 2.
AUTO_BURST, AUTO_NEW = 16, 128
#: The most bursts the deployment gets for its new replica to serve.
AUTO_WAVES = 4
AUTO_CONFIG = dict(min_replicas=1, max_replicas=2,
                   target_ongoing_requests=4.0, upscale_delay_s=0.5,
                   downscale_delay_s=2.0)


def _kv_sums(ks, vs):
    """Float64 sums of a handoff's K and V, computed where they lie."""
    import torch
    return (float(torch.sum(ks, dtype=torch.float64)),
            float(torch.sum(vs, dtype=torch.float64)))


class SmokeReplicaHost:
    """The fleet replicas' actor body in these phases: a ``ReplicaHost``,
    to which it hands every call, plus the replica's own kernel launch
    counts and the handoff checks of ``handoff_ipc``.  Module level: the
    replica imports it from this file."""

    def __init__(self, *args):
        from ray_tpu_torch.llm.fleet import ReplicaHost
        self.host = ReplicaHost(*args)

    def __getattr__(self, name):
        return getattr(self.host, name)

    def reset_launches(self) -> bool:
        _reset_launches()
        return True

    def read_launches(self):
        return _read_launches()

    def sums(self, desc):
        """Open a handoff by descriptor and sum its K/V on the card:
        (sums, ms to open the handles)."""
        from ray_tpu_torch.llm.disagg import import_handoff
        t0 = time.perf_counter()
        h, keep = import_handoff(desc)
        open_ms = (time.perf_counter() - t0) * 1e3
        out = _kv_sums(h.ks, h.vs)
        del h, keep
        return out, open_ms

    def sums_by_value(self, handoff):
        """The same sums of a handoff sent by value (pickled through the
        host)."""
        return _kv_sums(handoff.ks, handoff.vs)

    def import_timed(self, desc):
        """The replica's import of a descriptor, timed: (engine rid, ms
        to open the handles, device ms of the scatter on the engine's
        stream)."""
        import torch
        from ray_tpu_torch.llm.disagg import import_handoff
        rep = self.host._replica
        stream = rep.engine.stream
        t0 = time.perf_counter()
        h, keep = import_handoff(desc)
        t1 = time.perf_counter()
        if stream is None:                    # the CPU rehearsal
            rid = rep.import_prefill(h, retain=False)
            return rid, (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        # Under the engine's (reentrant) lock: no decode step of the drive
        # thread lands between the two events.
        with rep.engine._lock:
            start.record(stream)
            rid = rep.import_prefill(h, retain=False)
            end.record(stream)
        end.synchronize()
        del h, keep
        return rid, (t1 - t0) * 1e3, start.elapsed_time(end)

    def wait_finished(self, rid, timeout_s: float = 120.0):
        """The finish record of ``rid`` (no poller drains this host)."""
        deadline = time.perf_counter() + timeout_s
        kept = []
        while time.perf_counter() < deadline:
            for rec in self.host.drain_finished():
                if rec["rid"] == rid:
                    return rec
                kept.append(rec)
            time.sleep(0.005)
        raise TimeoutError(f"request {rid} did not finish")


def _replica_build(device: str = "cuda", model: str = "llama_1b"):
    import functools
    return functools.partial(deployment_params, 0, device, model)


def phase_handoff_ipc(smi, device: str = "cuda", model: str = "llama_1b"):
    """A llama_1b handoff of IPC_PROMPT tokens exported in this process
    and imported by a ReplicaHost process on the same card through CUDA
    IPC: the K/V sums the replica reads equal this process's; one element
    changed here after the export changes the replica's sums (it reads the
    shared bytes, not a copy); its greedy tokens equal an in-process
    import's.  Times the export, the open and the scatter beside a
    by-value transport (``_actor.put``) of the same handoff."""
    import dataclasses

    import torch
    from ray_tpu_torch import _actor
    from ray_tpu_torch import _object_store as store_mod
    from ray_tpu_torch.llm import InferenceEngine, SamplingParams
    from ray_tpu_torch.llm.disagg import PrefillWorker, export_handoff
    t0 = time.perf_counter()
    build = _replica_build(device, model)
    params, cfg = build()
    eo = dict(SERVE_OPTS, device=device)
    prompt = np.random.default_rng(31).integers(
        1, cfg.vocab_size, IPC_PROMPT).tolist()
    sp = SamplingParams(max_tokens=IPC_NEW)
    pw = PrefillWorker(params, cfg, device=device,
                       prefill_buckets=eo["prefill_buckets"],
                       page_size=eo["page_size"])
    h = pw.prefill(prompt, sp)
    # The reference: the same handoff imported in this process.
    eng = InferenceEngine(params, cfg, **eo)
    rid = eng.import_prefill(h)
    want = None
    while want is None:
        for r in eng.step():
            if r.request_id == rid:
                want = list(r.output_tokens)
    del eng
    gc.collect()
    host = _actor.remote(SmokeReplicaHost).options(
        max_concurrency=4, device=None if device == "cuda" else device
    ).remote(build, "ipc", eo, 1 << 20, False)
    store = store_mod.SharedMemoryStore()
    try:
        t1 = time.perf_counter()
        _actor.get(host.ping.remote(), timeout=600)
        host_start_s = time.perf_counter() - t1
        mine = _kv_sums(h.ks, h.vs)
        exports, opens, calls, scatters = [], [], [], []
        got = None
        for i in range(4):
            oid = store_mod.new_object_id()
            if device == "cuda":
                torch.cuda.synchronize()
            t1 = time.perf_counter()
            desc = export_handoff(store, oid, h)
            exports.append((time.perf_counter() - t1) * 1e3)
            check(desc is not None and desc[0] == (
                "cuda_ipc" if device == "cuda" else "shm"),
                f"handoff_ipc: descriptor {desc and desc[0]}")
            t1 = time.perf_counter()
            theirs, open_ms = _actor.get(host.sums.remote(desc), timeout=120)
            calls.append((time.perf_counter() - t1) * 1e3)
            opens.append(open_ms)
            check(theirs == mine, f"handoff_ipc: the replica's K/V sums "
                  f"{theirs} differ from the producer's {mine}")
            if i == 0:
                # The real path: the replica imports and decodes.
                rid2, _o, _s = _actor.get(host.import_timed.remote(desc),
                                          timeout=120)
                got = _actor.get(host.wait_finished.remote(rid2),
                                 timeout=180)["output_tokens"]
            else:
                _r, _o, scatter_ms = _actor.get(
                    host.import_timed.remote(desc), timeout=120)
                scatters.append(scatter_ms)
                host.cancel.remote(_r)
            store_mod.release_page_blob(store, oid)
        check(store.stats()["num_objects"] == 0,
              f"handoff_ipc: store not empty {store.stats()}")
        check(got == want, f"handoff_ipc: the replica's tokens {got} differ "
              f"from the in-process import's {want}")
        # By value: the same handoff pickled through the host.
        plain = dataclasses.replace(h, ready=None)
        by_value = []
        for _ in range(3):
            t1 = time.perf_counter()
            theirs = _actor.get(host.sums_by_value.remote(
                _actor.put(plain)), timeout=300)
            by_value.append((time.perf_counter() - t1) * 1e3)
            check(theirs == mine, "handoff_ipc: by-value sums differ")
        # The planted fault: one element changed after the export.
        oid = store_mod.new_object_id()
        desc = export_handoff(store, oid, h)
        before, _ = _actor.get(host.sums.remote(desc), timeout=120)
        with torch.no_grad():
            h.ks[0, 0, 0, 0] += 1.0
        if device == "cuda":
            torch.cuda.synchronize()
        mine_after = _kv_sums(h.ks, h.vs)
        after, _ = _actor.get(host.sums.remote(desc), timeout=120)
        store_mod.release_page_blob(store, oid)
        caught = after != before and after == mine_after
    finally:
        _actor.kill(host)
        store.shutdown()
    res = {"phase": "handoff_ipc", "model": model, "card": smi,
           "prompt_tokens": IPC_PROMPT, "handoff_bytes": h.nbytes,
           "transport": "cuda_ipc" if device == "cuda" else "shm",
           "export_ms": exports, "open_ms": opens, "sums_call_ms": calls,
           "scatter_ms": scatters, "by_value_call_ms": by_value,
           "export_ms_min": min(exports), "open_ms_min": min(opens),
           "scatter_ms_min": min(scatters),
           "ipc_call_ms_min": min(calls),
           "by_value_call_ms_min": min(by_value),
           "replica_start_s": host_start_s, "tokens_equal": got == want,
           "planted_fault_caught": caught,
           "seconds": time.perf_counter() - t0}
    emit(res)
    # Through CUDA IPC the replica reads the producer's memory, so the
    # change shows; a host transport (the CPU rehearsal) copied at export.
    check(caught == (device == "cuda"),
          f"handoff_ipc: a change to the producer's K after the export: "
          f"replica {before} -> {after}, producer {mine_after}")


def _remote_factory(build, eo, cache_bytes):
    from ray_tpu_torch.llm.fleet import RemoteReplica

    def factory(name, on_finish):
        return RemoteReplica(build, name=name, engine_options=eo,
                             cache_capacity_bytes=cache_bytes,
                             record_token_times=True, on_finish=on_finish,
                             host_cls=SmokeReplicaHost)
    return factory


def _time_remote_calls(srv):
    """Time, on the host clock, every call the router and the load
    generator make into a remote replica's handle: ``load_stats`` (a
    snapshot read), ``import_prefill`` and ``try_serve_cached`` (each one
    call to the replica process).  Returns {call: [ms, ...]}."""
    waits = {"load_stats": [], "import_prefill": [], "try_serve_cached": []}
    for rep in srv._replicas.values():
        for name, ms in waits.items():
            inner = getattr(rep, name)

            def timed(*a, _inner=inner, _ms=ms, **k):
                t0 = time.perf_counter()
                try:
                    return _inner(*a, **k)
                finally:
                    _ms.append((time.perf_counter() - t0) * 1e3)
            setattr(rep, name, timed)
    return waits


def phase_fleet_remote(smi, device: str = "cuda", model: str = "llama_1b"):
    """FleetServer with RemoteReplica processes: the prefill tier in this
    process, each decode replica in a process of its own on the card,
    every handoff crossing as CUDA IPC handles.  Greedy streams (one
    request at a time) equal an in-process FleetServer's on the same
    weights; the fleet's prefix-heavy traffic (as phase_fleet) on 1 and 2
    remote replicas, with the router's calls timed; a replica process
    killed while it holds requests (they shed as replica_lost, the
    manager backfills).  Launches: the flash forward counted in this
    process (the dispatcher's thread), the paged decode inside each
    replica."""
    import torch
    from ray_tpu_torch import _actor
    from ray_tpu_torch.llm import SamplingParams
    from ray_tpu_torch.llm.disagg import (PrefillWorker, ServeLoadSpec,
                                          run_open_loop)
    from ray_tpu_torch.llm.fleet import FleetConfig, FleetServer
    t0 = time.perf_counter()
    build = _replica_build(device, model)
    eo = dict(SERVE_OPTS, device=device)
    params, cfg = build()
    entry = PrefillWorker(params, cfg, device=device,
                          prefill_buckets=eo["prefill_buckets"],
                          page_size=eo["page_size"]).prefill(
        list(range(1, FLEET_PROMPT + 1)),
        SamplingParams(max_tokens=FLEET_MAX_TOKENS)).nbytes
    cache_bytes = int(entry * (FLEET_POOL // 2) + entry // 2)
    out = {"phase": "fleet_remote", "model": model, "card": smi,
           "pool": FLEET_POOL, "rps": FLEET_RPS,
           "duration_s": FLEET_DURATION_S,
           "cache_capacity_bytes": cache_bytes}
    rng = np.random.default_rng(41)
    exact = [rng.integers(1, cfg.vocab_size, n).tolist()
             for n, _ in REMOTE_EXACT[:-1]]
    exact.append(exact[0])
    bodies = [{"prompt_tokens": p, "max_tokens": m, "timeout_s": 300}
              for p, (_n, m) in zip(exact, REMOTE_EXACT)]
    # The reference: an in-process fleet on the same weights.
    ref_srv = FleetServer(lambda: (params, cfg), name="ref",
                          admission=_open_admission(),
                          config=FleetConfig(num_replicas=2,
                                             engine_options=eo,
                                             cache_capacity_bytes=cache_bytes))
    try:
        want = [ref_srv(b) for b in bodies]
    finally:
        ref_srv.close()
    del ref_srv
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    spec = dict(rps=FLEET_RPS, duration_s=FLEET_DURATION_S,
                long_fraction=1.0, long_prompt=FLEET_PROMPT,
                long_max_tokens=FLEET_MAX_TOKENS, short_prompt=32,
                short_max_tokens=FLEET_MAX_TOKENS, prompt_pool=FLEET_POOL,
                drain_timeout_s=120.0)
    totals = {"flash_fwd": 0, "paged_decode": 0}
    for n in (2, 1):
        name = f"remote{n}"
        t1 = time.perf_counter()
        srv = FleetServer(lambda: (params, cfg), name=name,
                          admission=_open_admission(),
                          config=FleetConfig(num_replicas=n,
                                             engine_options=eo,
                                             cache_capacity_bytes=cache_bytes,
                                             manager_interval_s=0.1),
                          record_token_times=True,
                          replica_factory=_remote_factory(build, eo,
                                                          cache_bytes))
        start_s = time.perf_counter() - t1
        try:
            if n == 2:
                got = [srv(b) for b in bodies]
                out["exact"] = {
                    "requests": len(bodies),
                    "tokens_equal": [g.get("output_tokens")
                                     for g in got]
                    == [w.get("output_tokens") for w in want],
                    "prefix_outcomes": [g.get("prefix_outcome")
                                        for g in got]}
                check(out["exact"]["tokens_equal"],
                      f"fleet_remote: streams differ from the in-process "
                      f"fleet's: {got} vs {want}")
            pubs = [srv.submit({"prompt_tokens": [1] * (FLEET_PROMPT - i),
                                "max_tokens": 2, "timeout_s": 300})
                    for i in range(2 * n)]
            for x in pubs:
                srv.result(x, timeout_s=300)
            reps = list(srv._replicas.values())
            waits = _time_remote_calls(srv)
            _actor.get([r.actor.reset_launches.remote() for r in reps],
                       timeout=60)
            # -- the main path: launch counts read from this window only,
            # in this process and in each replica's.
            _reset_launches()
            r = run_open_loop(srv, ServeLoadSpec(**spec), cfg.vocab_size)
            here = _launches_by_thread()
            remote = _actor.get([rep.actor.read_launches.remote()
                                 for rep in reps], timeout=60)
            # -- end of the main path.
            for rep in reps:
                for k in waits:
                    rep.__dict__.pop(k, None)
            st = srv.status()
            row = _load_row(r)
            launches = {
                "flash_fwd": here.get("flash_fwd", {}).get(
                    f"fleet-dispatch-{name}", 0),
                "paged_decode": sum(x["paged_decode"] for x in remote)}
            row.update(start_s=start_s, launches=launches,
                       paged_decode_by_replica=[x["paged_decode"]
                                                for x in remote],
                       prefix=st["prefix"], rebalances=st["rebalances"],
                       router_calls=_summarize_waits(waits),
                       in_process=FLEET_IN_PROCESS.get(n))
            for k in totals:
                totals[k] += launches[k]
            out[f"replicas_{n}"] = row
            emit({"phase": "fleet_remote", "replicas": n, **row})
            check(r["unfinished"] == 0 and r["errors"] == 0,
                  f"fleet_remote x{n}: {row}")
            check(device == "cpu" or (
                launches["flash_fwd"] > 0
                and all(x["paged_decode"] > 0 for x in remote)),
                  f"fleet_remote x{n}: launches {launches} by replica "
                  f"{remote}")
            if n == 2:
                out["kill"] = _remote_kill(srv, cfg)
        finally:
            srv.close()
    f1, f2 = out["replicas_1"], out["replicas_2"]
    out["scaling_2x"] = f2["sustained_rps"] / f1["sustained_rps"]
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = totals
    emit({k: v for k, v in out.items()
          if k not in ("replicas_1", "replicas_2")})
    return totals


def _remote_kill(srv, cfg):
    """A replica's process killed while it holds mapped requests: those
    shed retriably as replica_lost, the rest finish, the manager
    backfills a new process, and the fleet serves again."""
    from ray_tpu_torch import _actor
    rng = np.random.default_rng(21)
    pubs = [srv.submit({"prompt_tokens": rng.integers(
        0, cfg.vocab_size, 32).tolist(), "max_tokens": 50,
        "timeout_s": 300}) for _ in range(16)]
    deadline = time.perf_counter() + 60
    victim = None
    while victim is None and time.perf_counter() < deadline:
        with srv._lock:
            victim = next((name for name, _rid in srv._rid_map
                           if name in srv._replicas), None)
        time.sleep(0.005)
    check(victim is not None, "fleet_remote kill: no mapped request")
    t_kill = time.perf_counter()
    _actor.kill(srv._replicas[victim].actor)
    results = [srv.result(x, timeout_s=300) for x in pubs]
    deadline = time.perf_counter() + 300
    while time.perf_counter() < deadline:
        st = srv.status()
        names = [r["name"] for r in st["replicas"]]
        if len(names) == 2 and victim not in names:
            break
        time.sleep(0.05)
    backfill_s = time.perf_counter() - t_kill
    after = srv({"prompt_tokens": [9, 8, 7], "max_tokens": 3,
                 "timeout_s": 120})
    shed = [r for r in results if r.get("finish_reason") == "shed"]
    done = [r for r in results if r.get("finish_reason") == "length"]
    row = {"requests": len(results), "shed": len(shed),
           "replica_lost": sum(r.get("reason") == "replica_lost"
                               for r in shed),
           "finished": len(done), "replicas_after": len(names),
           "backfill_s": backfill_s, "served_after": "error" not in after}
    check(row["replica_lost"] > 0 and all(r.get("retriable") for r in shed)
          and len(shed) + len(done) == len(results)
          and row["replicas_after"] == 2 and row["served_after"],
          f"fleet_remote kill: {row}")
    return row


def _http_json(port, path, body):
    import urllib.request
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        raw = resp.read()
        if resp.headers["Content-Type"] == "application/x-ndjson":
            return [json.loads(x) for x in raw.splitlines() if x]
        return json.loads(raw)


def phase_serve_controller(smi, device: str = "cuda",
                           model: str = "llama_1b"):
    """build_llm_deployment at llama_1b with an AutoscalingConfig (1 to 2
    replicas): a burst of AUTO_BURST concurrent requests scales it to 2,
    and bursts go on until the new replica has served; idle scales it
    back to 1; the last replica's process killed, the controller
    backfills and requests are served again; one request through the HTTP
    ingress returns the handle's tokens, and a streamed one the handle's
    stream's items.  Launches counted inside each replica, zeroed just
    before the burst (the new replica's as it is published) and read just
    after; each replica must have launched both kernels."""
    from ray_tpu_torch import _actor, serve
    from ray_tpu_torch.llm import build_llm_deployment
    t0 = time.perf_counter()
    build = _replica_build(device, model)
    opts = dict(DEPLOY_OPTS, device=device)
    auto = serve.AutoscalingConfig(**AUTO_CONFIG)
    name = "auto"
    app = build_llm_deployment(build, name=name, engine_options=opts,
                               autoscaling_config=auto)
    app = serve.Application(app.deployment.options(cls_or_fn=SmokeLLMServer))
    bodies, stream_body = _deployment_bodies(build()[1].vocab_size)
    gc.collect()

    def n_replicas():
        return serve.status()[name]["num_replicas"]

    def on_replicas(method, replicas=None):
        if replicas is None:
            replicas = list(serve.api._state(name).replicas)
        return _actor.get([r.handle_request.remote(method, (), {})
                           for r in replicas], timeout=120)

    def wait_for(cond, timeout_s, what):
        deadline = time.perf_counter() + timeout_s
        while not cond():
            check(time.perf_counter() < deadline,
                  f"serve_controller: {what} within {timeout_s} s")
            time.sleep(0.05)

    t1 = time.perf_counter()
    handle = serve.run(app, http_port=0)
    start_s = time.perf_counter() - t1
    try:
        port = serve.api.http_address()[1]
        _actor.get(handle.remote(dict(bodies[0], max_tokens=2)), timeout=300)
        first = list(serve.api._state(name).replicas)
        on_replicas("reset_launches")
        # -- the main path: the burst.

        def burst():
            results = [None] * AUTO_BURST

            def one(i):
                results[i] = _actor.get(handle.remote(dict(
                    bodies[i % len(bodies)], max_tokens=AUTO_NEW)),
                    timeout=600)

            threads = [threading.Thread(target=one, args=(i,))
                       for i in range(AUTO_BURST)]
            for t in threads:
                t.start()

            def join():
                for t in threads:
                    t.join(timeout=600)
                check(all(r is not None
                          and len(r["output_tokens"]) == AUTO_NEW
                          for r in results), "serve_controller: burst outputs")
            return join

        t_burst = time.perf_counter()
        join = burst()
        wait_for(lambda: serve.api._state(name).target_replicas == 2,
                 60, "the decision to scale up")
        decide_s = time.perf_counter() - t_burst
        wait_for(lambda: n_replicas() == 2, 600, "scale up to 2")
        scale_up_s = time.perf_counter() - t_burst
        new = [r for r in serve.api._state(name).replicas if r not in first]
        check(len(new) == 1, f"serve_controller: new replicas {new}")
        on_replicas("reset_launches", new)
        # The bursts go on until the new replica has launched both kernels
        # (a replica starts in longer than one burst decodes).
        waves = 1
        while True:
            join()
            seen = on_replicas("read_launches", new)[0]
            if device == "cpu" or (seen["flash_fwd"] > 0
                                   and seen["paged_decode"] > 0):
                break
            check(waves < AUTO_WAVES, f"serve_controller: the new replica "
                  f"served none of {waves} bursts")
            join = burst()
            waves += 1
        new_served_s = time.perf_counter() - t_burst
        launches_by_replica = on_replicas("read_launches")
        # -- end of the main path.
        t1 = time.perf_counter()
        wait_for(lambda: n_replicas() == 1, 120, "scale down to 1")
        scale_down_s = time.perf_counter() - t1
        # The HTTP ingress against the handle.
        body = dict(bodies[1], max_tokens=DEPLOY_NEW)
        via_handle = _actor.get(handle.remote(body), timeout=300)
        via_http = _http_json(port, f"/{name}", body)["result"]
        streamer = handle.options(stream=True, method_name="stream")
        items = [_actor.get(r, timeout=300)
                 for r in streamer.remote(stream_body)]
        http_items = [x["result"] for x in _http_json(
            port, f"/{name}/stream", dict(stream_body, stream=True))]
        http_equal = via_http["output_tokens"] == \
            via_handle["output_tokens"]
        stream_equal = http_items == items
        # Recovery: the last replica's process dies.
        victim = serve.api._state(name).replicas[0]
        t_kill = time.perf_counter()
        _actor.kill(victim)
        recovered = None
        while recovered is None:
            check(time.perf_counter() - t_kill < 600,
                  "serve_controller: no answer after the kill")
            try:
                recovered = _actor.get(handle.remote(
                    dict(bodies[2], max_tokens=4)), timeout=600)
            except (_actor.RayTpuError, RuntimeError):
                time.sleep(0.05)
        recover_s = time.perf_counter() - t_kill
        replaced = victim not in serve.api._state(name).replicas
    finally:
        serve.shutdown()
    launches = {k: sum(x[k] for x in launches_by_replica)
                for k in ("flash_fwd", "paged_decode")}
    res = {"phase": "serve_controller", "model": model, "card": smi,
           "autoscaling": AUTO_CONFIG,
           "burst": AUTO_BURST, "new_tokens": AUTO_NEW,
           "replica_start_s": start_s, "scale_up_decided_s": decide_s,
           "scale_up_s": scale_up_s, "bursts": waves,
           "new_replica_served_s": new_served_s,
           "scale_down_s": scale_down_s, "recover_s": recover_s,
           "replaced": replaced, "http_equal": http_equal,
           "http_stream_equal": stream_equal, "launches": launches,
           "launches_by_replica": launches_by_replica,
           "seconds": time.perf_counter() - t0}
    emit(res)
    check(http_equal and stream_equal,
          f"serve_controller: HTTP {via_http} vs handle {via_handle}; "
          f"stream {http_items} vs {items}")
    check(replaced and len(recovered["output_tokens"]) == 4,
          f"serve_controller: recovery {recovered}")
    check(len(launches_by_replica) == 2 and (device == "cpu" or all(
        x["flash_fwd"] > 0 and x["paged_decode"] > 0
        for x in launches_by_replica)),
          f"serve_controller: kernels not launched in every replica "
          f"{launches_by_replica}")
    return launches


def phase_rl_remote(smi, device: str = "cuda"):
    """PPO with 2 remote env runners and 2 DDP learners on the card, 2
    iterations, the learner replicas bit-identical after; then IMPALA at
    its default config (2 remote runners, async), 2 iterations."""
    from ray_tpu_torch import _actor
    from ray_tpu_torch._tree import tree_leaves
    from ray_tpu_torch.rl import IMPALAConfig, PPOConfig
    t0 = time.perf_counter()
    algo = (PPOConfig().environment("CartPole-v1").resources(device=device)
            .env_runners(num_env_runners=2)
            .learners(num_learners=2).build_algo())
    build_s = time.perf_counter() - t0
    try:
        ddp = algo.learner_group._ddp
        iters = []
        for _ in range(2):
            t1 = time.perf_counter()
            out = algo.train()
            iters.append(time.perf_counter() - t1)
        ppo_loss = out["learner"]["loss"]
        replicas = _actor.get([r.get_weights.remote()
                               for r in algo.learner_group.remotes],
                              timeout=120)
        identical = all(np.array_equal(a, b) for a, b in zip(
            tree_leaves(replicas[0]), tree_leaves(replicas[1])))
        steps = out["num_env_steps_sampled"]
    finally:
        algo.stop()
    t2 = time.perf_counter()
    algo = IMPALAConfig().environment("CartPole-v1").resources(
        device=device).build_algo()
    try:
        impala = [algo.train() for _ in range(2)]
    finally:
        algo.stop()
    impala_s = time.perf_counter() - t2
    losses = [r["learner"]["loss"] for r in impala]
    res = {"phase": "rl_remote", "card": smi,
           "ppo": {"env_runners": 2, "learners": 2, "ddp": ddp,
                   "build_s": build_s, "s_per_iter": iters,
                   "env_steps_per_iter": steps,
                   "env_steps_per_s": steps / iters[-1],
                   "loss": ppo_loss, "replicas_identical": identical},
           "impala": {"env_runners": 2, "seconds": impala_s,
                      "losses": losses,
                      "env_steps": impala[-1]["num_env_steps_sampled"]},
           "seconds": time.perf_counter() - t0}
    emit(res)
    check(ddp and identical and np.isfinite(ppo_loss),
          f"rl_remote: PPO ddp={ddp} identical={identical} loss={ppo_loss}")
    check(all(np.isfinite(x) for x in losses),
          f"rl_remote: IMPALA losses {losses}")


class CollectiveMember:
    """One member of the collective phase's groups (module level: the
    actor imports it from this file)."""

    def __init__(self, rank: int, world: int):
        self.rank, self.world = rank, world

    def run(self, group: str, backend: str):
        from ray_tpu_torch import collective as col
        col.init_collective_group(self.world, self.rank, backend=backend,
                                  group_name=group)
        r = self.rank
        x = np.arange(1 << 20, dtype=np.float32) * (r + 1)
        out = {"allreduce": col.allreduce(x, group),
               "allgather": col.allgather(np.full(3, r, np.int64), group),
               "broadcast": col.broadcast(np.full(4, float(r)), 1, group),
               "reducescatter": col.reducescatter(
                   np.arange(2 * self.world, dtype=np.float64), group)}
        if r % 2 == 0 and r + 1 < self.world:
            col.send(np.full(5, r + 0.5, np.float32), r + 1, group)
        elif r % 2:
            out["recv"] = col.recv((5,), np.float32, r - 1, group)
        col.barrier(group)
        t0 = time.perf_counter()
        for _ in range(10):
            col.allreduce(x, group)
        out["allreduce_4mib_ms"] = (time.perf_counter() - t0) * 100
        col.destroy_collective_group(group)
        return out


def check_collective(results, world: int) -> bool:
    """Every member's results against numpy."""
    x = np.arange(1 << 20, dtype=np.float32)
    total = x * (world * (world + 1) / 2)
    ok = True
    for r, out in enumerate(results):
        ok &= np.array_equal(out["allreduce"], total)
        ok &= np.array_equal(out["allgather"],
                             np.repeat(np.arange(world), 3).reshape(world,
                                                                    3))
        ok &= np.array_equal(out["broadcast"], np.full(4, 1.0))
        ok &= np.array_equal(out["reducescatter"],
                             world * np.arange(2 * world)[2 * r:2 * r + 2])
        if r % 2:
            ok &= np.array_equal(out["recv"], np.full(5, r - 0.5,
                                                      np.float32))
    return bool(ok)


def phase_collective(smi):
    """A 2-process gloo group over host arrays (collective.allreduce,
    allgather, broadcast, reducescatter, send/recv, barrier) against
    numpy."""
    from ray_tpu_torch import _actor
    t0 = time.perf_counter()
    cls = _actor.remote(CollectiveMember).options(device="cpu", num_cpus=1)
    members = [cls.remote(r, 2) for r in range(2)]
    try:
        results = _actor.get([m.run.remote("smoke", "gloo")
                              for m in members], timeout=300)
    finally:
        for m in members:
            _actor.kill(m)
    ok = check_collective(results, 2)
    emit({"phase": "collective", "card": smi, "backend": "gloo",
          "world": 2, "correct": ok,
          "allreduce_4mib_ms": [r["allreduce_4mib_ms"] for r in results],
          "seconds": time.perf_counter() - t0})
    check(ok, "collective: a gloo op disagrees with numpy")


# -------------------------------------- compiled DAGs and developer tools

#: dag_disagg: DAG_REQUESTS requests of DAG_PROMPT prompt and DAG_NEW
#: generated tokens through prefill -> decode actors, DAG_DEPTH executes in
#: flight; the prefill actor keeps its last DAG_KEEP exported blobs (the
#: decode side finished every older one before the driver submitted the
#: next execute).
DAG_REQUESTS, DAG_PROMPT, DAG_NEW, DAG_DEPTH, DAG_KEEP = 16, 256, 64, 2, 2
DAG_OPTS = dict(max_slots=8, page_size=16, prefill_buckets=(256,),
                num_pages=8 * math.ceil((256 + 64 + 1) / 16) + 1)
#: The collective node: a 4 MiB fp32 tree from each of two actors,
#: DAG_COLL_ITERS iterations per op and mode.
DAG_COLL_SHAPES = {"w": (512, 1024), "b": [(256, 1024), (256, 1024)]}
DAG_COLL_ITERS = 5


class DagPrefill:
    """dag_disagg's prefill stage: a PrefillWorker whose ``run`` returns
    the export_handoff descriptor of one request (its K/V stay on the
    card; the descriptor carries their IPC handles).  Module level: the
    actor imports it from this file."""

    def __init__(self, build, eo):
        import collections

        from ray_tpu_torch import _object_store as store_mod
        from ray_tpu_torch.llm.disagg import PrefillWorker
        params, cfg = build()
        self.pw = PrefillWorker(params, cfg, device=eo["device"],
                                prefill_buckets=eo["prefill_buckets"],
                                page_size=eo["page_size"])
        self.store_mod = store_mod
        self.store = store_mod.SharedMemoryStore()
        self.sent = collections.deque()

    def run(self, req):
        from ray_tpu_torch.llm import SamplingParams
        from ray_tpu_torch.llm.disagg import export_handoff
        self._release(DAG_KEEP)
        h = self.pw.prefill(req["prompt_tokens"],
                            SamplingParams(max_tokens=req["max_tokens"]))
        oid = self.store_mod.new_object_id()
        desc = export_handoff(self.store, oid, h)
        check(desc is not None, "dag_disagg: the store refused a handoff")
        self.sent.append((oid, desc))
        return desc

    def _release(self, keep: int) -> None:
        while len(self.sent) > keep:
            oid, desc = self.sent.popleft()
            self.store_mod.settle_sends(desc, True)
            self.store_mod.release_page_blob(self.store, oid)

    def close(self) -> int:
        self._release(0)
        return self.store.stats()["num_objects"]

    def ping(self):
        return os.getpid()

    def reset_launches(self) -> bool:
        _reset_launches()
        return True

    def read_launches(self):
        return _read_launches()


class DagDecode:
    """dag_disagg's decode stage: an InferenceEngine that imports the
    handoff and generates greedily until the request finishes.  One run at
    a time (the interpreted graph sends two at once, on two call threads):
    a step on one thread would hand the other's finished request to the
    wrong caller."""

    def __init__(self, build, eo):
        from ray_tpu_torch.llm import InferenceEngine
        params, cfg = build()
        self.eng = InferenceEngine(params, cfg, **eo)
        self.lock = threading.Lock()
        self.ms = []

    def run(self, desc):
        with self.lock:
            t0 = time.perf_counter()
            try:
                return self._run(desc)
            finally:
                self.ms.append((time.perf_counter() - t0) * 1e3)

    def take_ms(self):
        """The ms of each run since the last take (import to finish)."""
        out, self.ms = self.ms, []
        return out

    def _run(self, desc):
        from ray_tpu_torch.llm.disagg import import_handoff
        h, keep = import_handoff(desc)
        rid = self.eng.import_prefill(h)
        check(rid is not None, "dag_disagg: no slot for the handoff")
        out = None
        while out is None:
            for r in self.eng.step():
                if r.request_id == rid:
                    out = list(r.output_tokens)
        # The scatter has run (the request decoded from it): let go.
        del h, keep
        return out

    def ping(self):
        return os.getpid()

    def reset_launches(self) -> bool:
        _reset_launches()
        return True

    def read_launches(self):
        return _read_launches()


class DagShard:
    """One participant of dag_disagg's collective node: a 4 MiB fp32 tree
    made on its card from (seed, rank)."""

    def __init__(self, rank, device="cuda"):
        self.rank = rank
        self.device = device

    def make(self, seed):
        import torch
        g = torch.Generator(device=self.device).manual_seed(
            int(seed) * 101 + self.rank)

        def leaf(shape):
            return torch.randn(shape, generator=g, device=self.device)
        return {"w": leaf(DAG_COLL_SHAPES["w"]),
                "b": [leaf(s) for s in DAG_COLL_SHAPES["b"]]}

    def host(self, seed):
        from ray_tpu_torch._tree import tree_map
        return tree_map(lambda t: t.cpu().numpy(), self.make(seed))

    def out(self, red):
        from ray_tpu_torch._tree import tree_map
        return tree_map(lambda t: (t.device.type, t.cpu().numpy()), red)

    def ping(self):
        return os.getpid()


def _dag_bodies(vocab):
    rng = np.random.default_rng(13)
    return [{"prompt_tokens": rng.integers(1, vocab, DAG_PROMPT).tolist(),
             "max_tokens": DAG_NEW} for _ in range(DAG_REQUESTS)]


def _run_pipelined(execute, get, bodies):
    """Each body one execute, DAG_DEPTH in flight: (outputs, ms per
    execute)."""
    import collections
    inflight, outs = collections.deque(), []
    t0 = time.perf_counter()
    for body in bodies:
        if len(inflight) == DAG_DEPTH:
            outs.append(get(inflight.popleft()))
        inflight.append(execute(body))
    while inflight:
        outs.append(get(inflight.popleft()))
    return outs, (time.perf_counter() - t0) * 1e3 / len(bodies)


def _dag_collective(smi, shards, device):
    """allreduce_bind over the two DagShard actors for each op, compiled
    and interpreted: every participant's reduced tree against numpy's
    reduction of the two contributions."""
    from ray_tpu_torch import _actor
    from ray_tpu_torch._tree import tree_leaves, tree_map
    from ray_tpu_torch.dag import InputNode, MultiOutputNode, allreduce_bind
    np_ops = {"sum": lambda a, b: a + b, "mean": lambda a, b: (a + b) / 2,
              "max": np.maximum, "min": np.minimum}
    res = {"bytes_per_contribution": 4 * sum(
        math.prod(s) for s in [DAG_COLL_SHAPES["w"]]
        + DAG_COLL_SHAPES["b"]), "iterations": DAG_COLL_ITERS}
    for op, np_op in np_ops.items():
        with InputNode() as inp:
            parts = [w.make.bind(inp) for w in shards]
            red = allreduce_bind(parts, op=op)
            node = MultiOutputNode([w.out.bind(r)
                                    for w, r in zip(shards, red)])
        row, errs = {}, []
        for mode in ("compiled", "interpreted"):
            if mode == "compiled":
                dag = node.experimental_compile(buffer_size_bytes=8 << 20)
                run = lambda seed: dag.execute(seed).get(timeout=120)  # noqa
            else:
                run = lambda seed: _actor.get(node.execute(seed),  # noqa
                                              timeout=120)
            try:
                run(0)                                   # warm-up
                t0 = time.perf_counter()
                got = [run(seed) for seed in range(1, DAG_COLL_ITERS + 1)]
                row[f"{mode}_ms_per_iter"] = (time.perf_counter() - t0) \
                    * 1e3 / DAG_COLL_ITERS
            finally:
                if mode == "compiled":
                    dag.teardown()
            for seed, outs in zip(range(1, DAG_COLL_ITERS + 1), got):
                a, b = _actor.get([w.host.remote(seed) for w in shards],
                                  timeout=120)
                want = tree_map(np_op, a, b)
                for out in outs:
                    leaves = _out_leaves(out)
                    check(all(kind == device for kind, _ in leaves),
                          f"dag collective {op}: the reduced tree is not "
                          f"on the {device}")
                    errs.append(max(float(np.max(np.abs(g - w)))
                                    for (_kind, g), w in
                                    zip(leaves, tree_leaves(want))))
        row["max_abs_err"] = max(errs)
        check(row["max_abs_err"] == 0.0,
              f"dag collective {op}: differs from numpy by "
              f"{row['max_abs_err']}")
        res[op] = row
    return res


def _out_leaves(out):
    """DagShard.out's (device kind, array) leaves, in tree order."""
    if isinstance(out, dict):
        return [x for k in sorted(out) for x in _out_leaves(out[k])]
    if isinstance(out, list):
        return [x for v in out for x in _out_leaves(v)]
    return [out]


def phase_dag_disagg(smi, device: str = "cuda", model: str = "llama_1b"):
    """A compiled DAG over two actor processes on the card, prefill ->
    decode at llama_1b full width and depth (seeded weights): each of
    DAG_REQUESTS requests is one execute, DAG_DEPTH in flight; the tokens
    equal the in-process LLMServer's; flash_fwd launches in the prefill
    process and paged_decode in the decode process; after teardown both
    actors answer calls.  The same graph interpreted (ordinary actor
    calls) beside it.  Then the collective node over two more actors.
    (``device="cpu"`` with ``llama_tiny`` and smaller DAG_* rehearses the
    phase where there is no card.)"""
    import functools

    import torch
    from ray_tpu_torch import _actor
    from ray_tpu_torch.dag import InputNode
    from ray_tpu_torch.llm import LLMServer
    t_phase = time.perf_counter()
    build = functools.partial(deployment_params, 0, device, model)
    eo = dict(DAG_OPTS, device=device)
    # A call thread beside the loop; None: the caller's card.
    opts = dict(max_concurrency=2, device=None if device == "cuda" else
                device)
    prefill = _actor.remote(DagPrefill).options(**opts).remote(build, eo)
    decode = _actor.remote(DagDecode).options(**opts).remote(build, eo)
    shards = [_actor.remote(DagShard).options(**opts).remote(r, device)
              for r in range(2)]
    try:
        t0 = time.perf_counter()
        pids = _actor.get([a.ping.remote() for a in
                           (prefill, decode, *shards)], timeout=600)
        start_s = time.perf_counter() - t0
        cfg = build()[1]
        bodies = _dag_bodies(cfg.vocab_size)
        # The reference: the in-process server on the same weights.
        server = LLMServer(build, eo)
        try:
            ref, _items, _ttft, ref_wall = _serve_all(
                server, lambda b: iter(()), bodies, None)
        finally:
            server.close()
        del server
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        ref_tokens = [r["output_tokens"] for r in ref]
        with InputNode() as inp:
            h = prefill.run.bind(inp)
            out = decode.run.bind(h)
        # Warm both stages through the interpreted graph (a whole request:
        # every decode step's shapes meet the libraries once here).
        _actor.get(out.execute(bodies[0]), timeout=300)
        _actor.get([prefill.reset_launches.remote(),
                    decode.reset_launches.remote(),
                    decode.take_ms.remote()], timeout=60)
        # -- the main path: launches counted in each actor.
        # Compiled and interpreted take turns, twice, the second pair on
        # half the requests (host-bound times move between runs; a single
        # pair put the first mode 19% behind); the first compiled round is
        # the counted path.
        rounds = {"compiled": [], "interpreted": []}
        outs, after = [], None
        for i, mode in enumerate(("compiled", "interpreted") * 2):
            batch = bodies if i < 2 else bodies[:DAG_REQUESTS // 2]
            if mode == "interpreted":
                got, ms = _run_pipelined(
                    out.execute, lambda r: _actor.get(r, timeout=300),
                    batch)
            else:
                dag = out.experimental_compile()
                try:
                    got, ms = _run_pipelined(
                        dag.execute, lambda r: r.get(timeout=300), batch)
                    if i == 0:
                        launches = {
                            "prefill": _actor.get(
                                prefill.read_launches.remote(), timeout=60),
                            "decode": _actor.get(
                                decode.read_launches.remote(), timeout=60)}
                        # -- end of the main path.
                finally:
                    dag.teardown()
                if i == 0:
                    after = _actor.get([prefill.ping.remote(),
                                        decode.ping.remote()], timeout=60)
            outs.append(got)
            runs = _actor.get(decode.take_ms.remote(), timeout=60)
            # The decode stage runs one request at a time, so an execute
            # costs its decode plus the time the stage waited for input:
            # the graph's own share (transport, planning, a prefill not
            # hidden) is what is left past the decode.
            rounds[mode].append({
                "ms_per_execute": ms, "decode_run_ms_p50": pct(runs, 50),
                "beyond_decode_ms": ms - sum(runs) / len(runs)})
        left = _actor.get(prefill.close.remote(), timeout=60)
        coll = _dag_collective(smi, shards, device)
    finally:
        for a in (prefill, decode, *shards):
            _actor.kill(a)
    res = {"phase": "dag_disagg", "model": model, "card": smi,
           "requests": DAG_REQUESTS, "prompt_tokens": DAG_PROMPT,
           "new_tokens": DAG_NEW, "in_flight": DAG_DEPTH,
           "actors_start_s": start_s,
           # Each round's ms an execute, the decode stage's own ms a
           # request (import to finish, p50), and the ms an execute
           # costs past the mean decode: the graph's own.
           "compiled": rounds["compiled"],
           "interpreted": rounds["interpreted"],
           "in_process_ms_per_request": ref_wall * 1e3 / DAG_REQUESTS,
           "tokens_equal": all(o == ref_tokens[:len(o)] for o in outs),
           "answering_after_teardown": after == pids[:2],
           "blobs_left": left,
           "launches_by_process": {
               k: {n: v[n] for n in ("flash_fwd", "paged_decode")}
               for k, v in launches.items()},
           "collective": coll,
           "seconds": time.perf_counter() - t_phase}
    emit(res)
    check(all(len(t) == DAG_NEW for t in outs[0]),
          f"dag_disagg: short outputs {[len(t) for t in outs[0]]}")
    check(res["tokens_equal"],
          "dag_disagg: the DAG's greedy tokens differ from the in-process "
          "server's on the same weights")
    check(device == "cpu" or (launches["prefill"]["flash_fwd"] > 0
                              and launches["decode"]["paged_decode"] > 0),
          f"dag_disagg: kernels not launched in their stages {launches}")
    check(res["answering_after_teardown"] and left == 0,
          f"dag_disagg: after teardown {after} vs {pids[:2]}, {left} "
          f"blobs left")
    return {"flash_fwd": launches["prefill"]["flash_fwd"],
            "paged_decode": launches["decode"]["paged_decode"]}


#: sync_tripwire: serve's llama_1b mix (run_pipelined(32)).
TRIP_REQUESTS, TRIP_PROMPT, TRIP_NEW = 32, 256, 128


def _planted_item_loop(n):
    """A per-token ``.item()`` (the defect RT502 names), planted: returns
    (the values, the line of the coercion)."""
    import torch
    toks = torch.arange(n, dtype=torch.int32, device="cuda")
    vals = [toks[i].item() for i in range(n)]
    return vals, sys._getframe().f_lineno - 1


def phase_sync_tripwire(smi):
    """syncdebug.install() around serve's llama_1b mix (32 x (256 + 128)
    through run_pipelined(32)) and one default PPO iteration: 0 syncs per
    decode chunk (and its agreement with torch's sync debug mode on one
    chunk, _chunk_syncs), RL's syncs per env step and per update, and a
    planted per-token .item() reported at its own line.  gen_tok_s with
    and without the tripwire, in this process."""
    import torch
    from ray_tpu_torch.devtools import syncdebug
    from ray_tpu_torch.llm import InferenceEngine, SamplingParams
    from ray_tpu_torch.models.llama import init_params, llama_1b
    from ray_tpu_torch.rl import PPOConfig
    t_phase = time.perf_counter()
    cfg = llama_1b()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         param_dtype=torch.bfloat16, device="cuda")
    page = 16
    opts = dict(device="cuda", max_slots=32, page_size=page,
                prefill_buckets=(256,),
                num_pages=TRIP_REQUESTS * math.ceil(
                    (TRIP_PROMPT + TRIP_NEW + 1) / page) + 1)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, size=TRIP_PROMPT).tolist()
               for _ in range(TRIP_REQUESTS)]
    eng = InferenceEngine(params, cfg, **opts)
    eng.generate([prompts[0][:32]], SamplingParams(max_tokens=2))

    def serve_mix():
        for p in prompts:
            eng.add_request(p, SamplingParams(max_tokens=TRIP_NEW))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = eng.run_pipelined(32)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(len(done) == TRIP_REQUESTS and all(
            len(r.output_tokens) == TRIP_NEW for r in done),
            "sync_tripwire: run_pipelined did not finish every request")
        return TRIP_REQUESTS * TRIP_NEW / wall

    # Without and with the tripwire, taking turns (host-bound throughput
    # moves between runs): the first run with it is the counted path.
    without, with_tw = [serve_mix()], []
    syncdebug.clear()
    syncdebug.install()
    try:
        # -- the main path: launch counts read from this window only.
        _reset_launches()
        with_tw.append(serve_mix())
        launches = _read_launches()
        # -- end of the main path.
        serve_rep = syncdebug.report()
        syncdebug.uninstall()
        without.append(serve_mix())
        syncdebug.install()
        syncdebug.clear()
        with_tw.append(serve_mix())
        check(syncdebug.report()["total_syncs"] == 0,
              f"sync_tripwire: syncs in a second run {syncdebug.report()}")
        serve_rep["total_syncs"] += syncdebug.report()["total_syncs"]
        # One decode chunk alone, under both instruments.
        syncdebug.clear()
        chunk = _chunk_syncs(params, cfg, prompts[2], page)
        chunk_tw = syncdebug.report()["total_syncs"]
        # One default PPO iteration, then a sample and an update with
        # torch's sync debug mode beside the tripwire.
        algo = PPOConfig().environment("CartPole-v1").resources(
            device="cuda").build()
        algo.train()
        syncdebug.clear()
        algo.train()
        ppo_rep = syncdebug.report()
        rcfg = algo.config
        runner = algo.env_runner_group.local
        syncdebug.clear()
        batch, sample_syncs = _rl_syncs(lambda: runner.sample(
            rcfg.rollout_fragment_length))
        sample_tw = syncdebug.report()["total_syncs"]
        mb = {k: v.reshape(-1, *v.shape[2:])[:rcfg.minibatch_size]
              for k, v in batch.items() if k in ("obs", "actions")}
        n = len(mb["actions"])
        import ray_tpu_torch.rl.ppo as ppo_mod
        mb.update(logp_old=batch["logp"].reshape(-1)[:n],
                  advantages=np.ones(n, np.float32),
                  value_targets=np.zeros(n, np.float32),
                  **ppo_mod.ppo_consts(rcfg))
        syncdebug.clear()
        _m, update_syncs = _rl_syncs(
            lambda: algo.learner_group.update(mb))
        update_tw = syncdebug.report()["total_syncs"]
        # The planted per-token .item().
        syncdebug.clear()
        vals, line = _planted_item_loop(64)
        planted = syncdebug.report()
    finally:
        syncdebug.uninstall()
        syncdebug.clear()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    site = f"chip_smoke.py:{line}"
    hit = [r for r in planted["sites"] if r["site"] == site]
    res = {"phase": "sync_tripwire", "model": "llama_1b", "card": smi,
           "requests": TRIP_REQUESTS, "prompt_tokens": TRIP_PROMPT,
           "new_tokens": TRIP_NEW,
           "gen_tok_s_without": without, "gen_tok_s_with": with_tw,
           "with_over_without": sum(with_tw) / sum(without),
           "serve_syncs": serve_rep["total_syncs"],
           "serve_sites": serve_rep["sites"][:5],
           "decode_chunk": {"tripwire": chunk_tw,
                            "sync_debug_mode": chunk["inside_chunk"],
                            "sync_debug_mode_with_readback":
                                chunk["with_readback"]},
           "ppo_iteration": {"tripwire": ppo_rep["total_syncs"],
                             "sites": ppo_rep["sites"][:5]},
           "rl_sample": {"env_steps": rcfg.rollout_fragment_length,
                         "sync_debug_mode": sample_syncs,
                         "tripwire": sample_tw},
           "rl_update": {"sync_debug_mode": update_syncs,
                         "tripwire": update_tw},
           "planted": {"site": site, "found": hit[:1],
                       "sites": [r["site"] for r in planted["sites"]]},
           "launches": {k: launches[k] for k in ("flash_fwd",
                                                 "paged_decode")},
           "seconds": time.perf_counter() - t_phase}
    emit(res)
    check(serve_rep["total_syncs"] == 0 and chunk_tw == 0
          and chunk["inside_chunk"] == 0,
          f"sync_tripwire: syncs in the decode path: tripwire "
          f"{serve_rep['total_syncs']} over the mix, {chunk_tw} in a chunk; "
          f"sync debug mode {chunk['inside_chunk']} in a chunk")
    check(sample_syncs == rcfg.rollout_fragment_length + 1
          and update_syncs == 1,
          f"sync_tripwire: RL syncs {sample_syncs} a sample of "
          f"{rcfg.rollout_fragment_length} steps, {update_syncs} an update")
    check(sample_tw <= sample_syncs and update_tw <= update_syncs,
          "sync_tripwire: the tripwire counts more than the syncs")
    check(len(hit) == 1 and hit[0]["count"] == 64 and hit[0]["kind"]
          == "item" and vals == list(range(64)),
          f"sync_tripwire: the planted .item() was not reported at {site}: "
          f"{planted['sites']}")
    check(launches["flash_fwd"] > 0 and launches["paged_decode"] > 0,
          f"sync_tripwire: kernels not launched {launches}")
    return res["launches"]


#: recompile: llama_tiny decode chunks at these batch sizes (the second a
#: new launch shape for the warm site).
RECOMPILE_BATCHES = (3, 7)


def phase_recompile(smi):
    """profiler.recompile on the serve_tiny configuration (llama_tiny,
    bf16): a tracked decode site counts its builds and first launches on
    the first pass and none on a warm pass; a new batch size then bumps
    ray_tpu_profiler_recompiles_total by one and logs one warning naming
    the shape."""
    import logging

    import torch
    from ray_tpu_torch.llm import _model
    from ray_tpu_torch.models.llama import init_params, llama_tiny
    from ray_tpu_torch.profiler import recompile
    from ray_tpu_torch.util import telemetry
    cfg = llama_tiny().replace(dtype=torch.bfloat16)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         param_dtype=torch.bfloat16, device="cuda")
    page, P, steps = 16, 3, 8

    def inputs(B):
        kv = tuple(torch.zeros((B * P + 1, page, 2 * cfg.kv_heads,
                                cfg.head_dim), dtype=cfg.dtype,
                               device="cuda") for _ in range(cfg.layers))
        bt = (torch.arange(B * P, dtype=torch.int32, device="cuda")
              .view(B, P) + 1)
        tok = torch.full((B,), 5, dtype=torch.int32, device="cuda")
        pos = torch.full((B,), 20, dtype=torch.int32, device="cuda")
        active = torch.ones(B, dtype=torch.bool, device="cuda")
        return kv, tok, pos, bt, active

    warnings_seen = []

    class _Catch(logging.Handler):
        def emit(self, record):
            warnings_seen.append(record.getMessage())

    handler = _Catch(level=logging.WARNING)
    logging.getLogger("ray_tpu_torch.profiler").addHandler(handler)
    recompile._reset_for_tests()
    before = sum(v[1] for v in telemetry.samples(
        "ray_tpu_profiler_recompiles_total").values())
    site = recompile.track(_model.decode_chunk, name="serve_tiny.decode")
    gen = torch.Generator(device="cuda").manual_seed(1)
    passes = []
    try:
        # -- the main path: launch counts read from this window only.
        _reset_launches()
        for B in (RECOMPILE_BATCHES[0], RECOMPILE_BATCHES[0],
                  RECOMPILE_BATCHES[1]):
            kv, tok, pos, bt, active = inputs(B)
            c0 = recompile.report().get("serve_tiny.decode",
                                        {"compiles": 0})["compiles"]
            site(params, kv, tok, pos, bt, active, gen, cfg, page, steps,
                 0.0, 0)
            torch.cuda.synchronize()
            passes.append(recompile.report()["serve_tiny.decode"]
                          ["compiles"] - c0)
        launches = _read_launches()
        # -- end of the main path.
        rep = recompile.report()["serve_tiny.decode"]
    finally:
        logging.getLogger("ray_tpu_torch.profiler").removeHandler(handler)
        recompile.uninstall()
    bumped = sum(v[1] for v in telemetry.samples(
        "ray_tpu_profiler_recompiles_total").values()) - before
    warns = [w for w in warnings_seen if "post-warmup" in w]
    shape = f"int32[{RECOMPILE_BATCHES[1]}]"
    res = {"phase": "recompile", "model": "llama_tiny", "card": smi,
           "batches": list(RECOMPILE_BATCHES),
           "events_by_pass": passes, "events": rep["events"],
           "compile_seconds": rep["compile_seconds"],
           "recompiles_total_bumped": bumped, "warnings": warns,
           "launches": {"paged_decode": launches["paged_decode"]}}
    emit(res)
    check(passes[0] >= 1 and passes[1] == 0 and passes[2] >= 1,
          f"recompile: events by pass {passes}")
    check(bumped == 1 and len(warns) == 1 and shape in warns[0],
          f"recompile: recompiles_total +{bumped}, warnings {warns}")
    check(launches["paged_decode"] > 0,
          f"recompile: paged_decode not launched {launches}")
    return res["launches"]


def _profile_serving(smi, handle, bodies, replica_pid):
    """profiler.profile(duration_s=2.0, torch_profile=True) while the
    serve_deployment replica serves a stream of requests: the merged
    trace holds the driver and the replica process, the replica's CUDA
    events name both kernels, and no process is unresponsive."""
    from ray_tpu_torch import _actor, profiler
    stop = threading.Event()
    served = [0]

    def client(i):
        while not stop.is_set():
            body = dict(bodies[i % len(bodies)], max_tokens=8)
            _actor.get(handle.remote(body), timeout=300)
            served[0] += 1

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(6)]
    for t in threads:
        t.start()
    try:
        time.sleep(1.0)
        t0 = time.perf_counter()
        res = profiler.profile(duration_s=2.0, torch_profile=True)
        call_s = time.perf_counter() - t0
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=300)
    procs = res["trace"]["otherData"]["processes"]
    replica = f"pid={replica_pid}"
    kernel_names = sorted({e["name"] for e in res["trace"]["traceEvents"]
                           if e.get("cat") == "kernel"
                           and str(e.get("pid", "")).endswith(replica)})
    out = {"phase": "profile", "card": smi, "duration_s": 2.0,
           "call_s": call_s, "call_seconds": res["seconds"],
           "requests_served": served[0],
           "events": res["num_events"],
           "trace_bytes": os.path.getsize(res["path"]),
           "workers": res["workers"], "unresponsive": res["unresponsive"],
           "processes": [{k: p.get(k) for k in
                          ("pid", "is_driver", "clock_offset_s",
                           "num_samples", "torch_profile")}
                         for p in procs],
           "replica_kernel_names": [n[:80] for n in kernel_names[:12]]}
    emit(out)
    pids = {p["pid"] for p in procs}
    check(os.getpid() in pids and replica_pid in pids,
          f"profile: processes {pids}, want the driver and {replica_pid}")
    check(any("flash_fwd" in n for n in kernel_names)
          and any("paged_decode" in n for n in kernel_names),
          f"profile: the replica's kernels {kernel_names[:20]}")
    check(res["unresponsive"] == [],
          f"profile: unresponsive {res['unresponsive']}")
    return out


# -- the developer tools and one-host surfaces on the card -----------------------
# lock_profile (in the serving tiers: the contention profiler and the
# lock-order detector over the in-process fleet), sanitize (the leak
# sanitizer over a serve deployment, a card task and a CUDA IPC handoff,
# then a planted leak), trace_metrics (a trace across a card task and its
# nested task, ActorPool over two card actors, a Queue, a metrics scrape).

#: The profiled run's and the detector's burst's seconds (FLEET_RPS, the
#: fleet's spec otherwise).
LOCK_PROFILE_S, LOCK_ORDER_S = 3.0, 1.5
#: The cache the fleet phase gave a replica (set there).
FLEET_CACHE = {}


def _engine_lock_site() -> str:
    """``engine.py:<line>``: where InferenceEngine creates its lock, the
    site the contention profiler names it by."""
    import ray_tpu_torch.llm.engine as eng
    with open(eng.__file__) as f:
        for i, line in enumerate(f, 1):
            if "self._lock = threading.RLock()" in line:
                return f"engine.py:{i}"
    raise RuntimeError("InferenceEngine's lock not found")


def _lock_row(report, site):
    rows = [r for r in report["sites"] if r["site"] == site]
    if not rows:
        return None
    r = rows[0]
    return {"site": site, "locks": r["locks"], "acquires": r["acquires"],
            "contended": r["contended"],
            "wait_p50_ms": r["wait_p50_s"] * 1e3,
            "wait_p99_ms": r["wait_p99_s"] * 1e3,
            "contended_wait_p50_ms": r["contended_wait_p50_s"] * 1e3,
            "contended_wait_p99_ms": r["contended_wait_p99_s"] * 1e3,
            "wait_max_ms": r["wait_max_s"] * 1e3,
            "hold_p50_ms": r["hold_p50_s"] * 1e3,
            "hold_max_ms": r["hold_max_s"] * 1e3}


def _fleet_spec(duration_s):
    return dict(rps=FLEET_RPS, duration_s=duration_s, long_fraction=1.0,
                long_prompt=FLEET_PROMPT, long_max_tokens=FLEET_MAX_TOKENS,
                short_prompt=32, short_max_tokens=FLEET_MAX_TOKENS,
                prompt_pool=FLEET_POOL, drain_timeout_s=120.0)


def _fleet_one(params, cfg, name):
    from ray_tpu_torch.llm.fleet import FleetConfig, FleetServer
    srv = FleetServer(lambda: (params, cfg), name=name,
                      admission=_open_admission(),
                      config=FleetConfig(
                          num_replicas=1, engine_options=dict(SERVE_OPTS),
                          cache_capacity_bytes=FLEET_CACHE["bytes"]),
                      record_token_times=True)
    pubs = [srv.submit({"prompt_tokens": [1] * (FLEET_PROMPT - i),
                        "max_tokens": 2, "timeout_s": 300})
            for i in range(2)]
    for x in pubs:
        srv.result(x, timeout_s=300)
    return srv


def phase_lock_profile(smi, params, cfg):
    """The port's contention profiler (``RAY_TPU_LOCK_PROFILE``'s
    ``install_profile``), installed before a one-replica in-process fleet
    is built (only locks made after install are instrumented), over the
    fleet's traffic at FLEET_RPS with ``_time_router_calls`` on as well:
    the engine lock's waits and holds by creation site beside the hand
    timer's router-call times.  Then a shorter burst under the lock-order
    detector (``install``), its findings printed.  The launches are the
    profiled run's, in this process."""
    import torch
    from ray_tpu_torch.devtools import lockdebug
    from ray_tpu_torch.llm.disagg import ServeLoadSpec, run_open_loop
    t0 = time.perf_counter()
    site = _engine_lock_site()
    out = {"phase": "lock_profile", "model": "llama_1b", "card": smi,
           "rps": FLEET_RPS, "duration_s": LOCK_PROFILE_S,
           "engine_lock_site": f"ray_tpu_torch/llm/{site}"}
    lockdebug.install_profile()
    try:
        srv = _fleet_one(params, cfg, "lockprof")
        try:
            waits = _time_router_calls(srv)
            lockdebug.clear_contention()
            torch.cuda.synchronize()
            # -- the main path: launch counts read from this window only.
            _reset_launches()
            r = run_open_loop(srv, ServeLoadSpec(**_fleet_spec(
                LOCK_PROFILE_S)), cfg.vocab_size)
            torch.cuda.synchronize()
            launches = {k: v for k, v in _read_launches().items()
                        if k in ("flash_fwd", "paged_decode")}
            # -- end of the main path.
            report = lockdebug.contention_report(top=10_000)
            _untime_router_calls(srv, waits)
        finally:
            srv.close()
    finally:
        lockdebug.uninstall_profile()
    row = _lock_row(report, site)
    out.update(load=_load_row(r), engine_lock=row,
               router_calls=_summarize_waits(waits),
               hottest_sites=[{k: x[k] for k in ("site", "kind", "acquires",
                                                 "contended", "wait_total_s")}
                              for x in report["sites"][:5]],
               launches=launches)
    plain = FLEET_IN_PROCESS.get(1) or {}
    out["itl_p50_ms_plain"] = plain.get("itl_p50_ms")
    out["itl_p50_ms_profiled"] = r["itl_p50_ms"]
    check(r["unfinished"] == 0 and r["errors"] == 0,
          f"lock_profile: {out['load']}")
    check(row is not None and row["acquires"] > 0 and row["contended"] > 0,
          f"lock_profile: the profiler did not see the engine lock "
          f"({site}) contended: {row}; hottest {out['hottest_sites']}")
    check(launches["flash_fwd"] > 0 and launches["paged_decode"] > 0,
          f"lock_profile: launches {launches}")
    # The lock-order detector over a shorter burst on a fresh fleet.
    t1 = time.perf_counter()
    lockdebug.install()
    lockdebug.clear()
    try:
        srv = _fleet_one(params, cfg, "lockorder")
        try:
            r2 = run_open_loop(srv, ServeLoadSpec(**_fleet_spec(
                LOCK_ORDER_S)), cfg.vocab_size)
            found = lockdebug.findings()
            rep = lockdebug.report()
            drow = _lock_row(lockdebug.contention_report(top=10_000), site)
        finally:
            srv.close()
    finally:
        lockdebug.uninstall()
    out["order_detector"] = {
        "seconds": time.perf_counter() - t1, "edges": rep["edges"],
        "engine_lock_acquires": drow["acquires"] if drow else 0,
        "findings": [{"kind": f["kind"], "site": f.get("site"),
                      "thread": f.get("thread"),
                      "cycle": f.get("cycle"),
                      "held_locks": f.get("held_locks"),
                      "blocking_call": f.get("blocking_call"),
                      "stack": f.get("stack")} for f in found],
        "load": _load_row(r2)}
    check(drow is not None and drow["acquires"] > 0,
          "lock_profile: the order detector did not instrument the engine "
          "lock")
    check(r2["unfinished"] == 0 and r2["errors"] == 0,
          f"lock_profile: the detector's burst {out['order_detector']}")
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return launches


def flash_probe(seed: int):
    """The flash forward at SCHED_SHAPE on this process's card against its
    plain version: launches and the largest difference (module level: a
    task worker or an actor imports it)."""
    import torch
    from ray_tpu_torch.ops.attention import flash_fwd, reference_attention
    sh = SCHED_SHAPE
    q, k, v = _flash_inputs(sh["B"], sh["H"], sh["Hkv"], sh["S"], sh["S"],
                            sh["D"], torch.bfloat16, seed)
    before = flash_fwd.launches
    out, _ = flash_fwd(q, k, v, causal=True)
    launches = flash_fwd.launches - before
    ref = reference_attention(q, k, v, causal=True)
    err = (out.float() - ref.float()).abs().max().item()
    return {"launches": launches, "max_abs_err": err, "pid": os.getpid()}


class SanitizeFlash:
    """The sanitize phase's deployment: each request runs the flash
    forward on the replica's card."""

    def __call__(self, seed):
        return flash_probe(int(seed))


def ipc_read_task(desc):
    """A card task opening a CUDA IPC handoff: the sum of the exporter's
    tensor, read in place."""
    from ray_tpu_torch._object_store import import_page_blob
    value, _keep = import_page_blob(desc)
    return float(value.float().sum().item())


def _thread_start_us(n: int = 200) -> float:
    """Mean µs of a framework thread's start and join, started through the
    sanitizer's ``spawn`` (the port's tree), as recorded or not."""
    from ray_tpu_torch import _sanitizer
    t0 = time.perf_counter()
    for _ in range(n):
        _sanitizer.spawn(int, name="sanitize-cost").join()
    return (time.perf_counter() - t0) / n * 1e6


def phase_sanitize(smi):
    """The port's leak sanitizer installed (``RAY_TPU_SANITIZE``'s
    ``install``) over ``init()``, a one-replica serve deployment on the
    card answering requests (the flash forward each), a card task running
    the flash forward, and a CUDA tensor put into the object store and
    read over IPC in a card task: ``shutdown()`` raises no LeakError.
    Then a planted leak (the metrics server's thread, started from the
    port's tree and left running) must raise.  Its cost: a framework
    thread's start with the sanitizer off and on, and the gate's time."""
    import torch
    import ray_tpu_torch as rtt
    from ray_tpu_torch import _object_store, _sanitizer, serve
    from ray_tpu_torch.util import metrics
    t0 = time.perf_counter()
    out = {"phase": "sanitize", "card": smi}
    was_on = _sanitizer.is_enabled()
    _sanitizer.uninstall()
    cost_off = [_thread_start_us() for _ in range(3)]
    _sanitizer.install()
    cost_on = [_thread_start_us() for _ in range(3)]
    out["thread_start_us"] = {"off": min(cost_off), "on": min(cost_on)}
    try:
        rtt.init(num_cpus=4)
        handle = serve.run(serve.deployment(
            SanitizeFlash, name="sanitize_flash",
            ray_actor_options={"device": "cuda"}))
        served = [rtt.get(handle.remote(s), timeout=600) for s in range(3)]
        task = rtt.get(rtt.remote(num_tpus=1)(flash_probe).remote(7),
                       timeout=600)
        store = _object_store.SharedMemoryStore()
        x = torch.randn(1 << 20, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(3))
        oid = _object_store.new_object_id()
        desc = _object_store.export_page_blob(store, oid, x)
        check(desc is not None and desc[0] == "cuda_ipc",
              f"sanitize: the CUDA tensor's descriptor {desc}")
        pinned = _sanitizer.report()["pins"]
        theirs = rtt.get(rtt.remote(num_tpus=1)(ipc_read_task).remote(desc),
                         timeout=600)
        _object_store.settle_sends(desc, delivered=True)
        _object_store.release_page_blob(store, oid)
        mine = float(x.sum().item())
        del x
        during = _sanitizer.report()
        serve.shutdown()
        t_gate = time.perf_counter()
        rtt.shutdown()            # raises LeakError on any leak
        out["shutdown_s"] = time.perf_counter() - t_gate
        after = _sanitizer.report()
        out.update(
            served=[{k: r[k] for k in ("launches", "max_abs_err")}
                    for r in served],
            task={k: task[k] for k in ("launches", "max_abs_err")},
            ipc={"sum_exporter": mine, "sum_importer": theirs,
                 "pins_while_exported": len(pinned)},
            registries_during={k: len(during[k]) for k in
                               ("threads", "pins", "files", "named_actors")},
            registries_after={k: len(after[k]) for k in
                              ("threads", "pins", "files", "named_actors")})
        tol = TOL["bfloat16"]
        check(all(r["launches"] >= 1 and r["max_abs_err"] <= tol
                  for r in served + [task]),
              f"sanitize: flash on the card {out['served']} {out['task']}")
        check(len(pinned) >= 1, "sanitize: the export was not pinned")
        check(abs(theirs - mine) <= 1e-3 * max(1.0, abs(mine)),
              f"sanitize: IPC read {theirs} != {mine}")
        # The planted leak: a framework thread left running.
        rtt.init(num_cpus=1)
        port = metrics.start_metrics_server(0)
        grace, _sanitizer.DEFAULT_GRACE_S = _sanitizer.DEFAULT_GRACE_S, 1.0
        try:
            rtt.shutdown()
            planted = None
        except _sanitizer.LeakError as e:
            planted = str(e)
        finally:
            _sanitizer.DEFAULT_GRACE_S = grace
            metrics.stop_metrics_server()
        out["planted"] = {"raised": planted is not None,
                          "metrics_port": port,
                          "report": planted}
        check(planted is not None and "ray_tpu-metrics-http" in planted,
              f"sanitize: the planted leak did not raise: {planted}")
    finally:
        if not was_on:
            _sanitizer.uninstall()
    out["launches"] = {"flash_fwd": sum(r["launches"]
                                        for r in served + [task])}
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return out["launches"]


def traced_card_task(seed: int):
    """A card task that runs the flash forward and submits a nested task
    (module level: the worker imports it)."""
    import ray_tpu_torch as rtt
    r = flash_probe(seed)
    r["nested"] = rtt.get(rtt.remote(trace_leaf).remote(seed), timeout=120)
    return r


def trace_leaf(x):
    return x + 1


def queue_producer(queue, n: int):
    for i in range(n):
        queue.put(i * i)
    return n


class CardShard:
    """A card actor: the flash forward on its share of a batch, a Queue's
    consumer, and a user Counter and Histogram."""

    def __init__(self):
        from ray_tpu_torch.util import metrics
        self.calls = metrics.Counter("smoke_shard_calls_total",
                                     "CardShard calls", ("method",))
        self.ms = metrics.Histogram("smoke_shard_forward_ms",
                                    "CardShard forward ms",
                                    boundaries=[1.0, 10.0, 100.0, 1000.0])

    def forward(self, q, k, v):
        import torch
        from ray_tpu_torch.ops.attention import flash_fwd
        t0 = time.perf_counter()
        before = flash_fwd.launches
        out, _ = flash_fwd(q.cuda(), k.cuda(), v.cuda(), causal=True)
        out = out.cpu()
        torch.cuda.synchronize()
        self.calls.inc(1.0, tags={"method": "forward"})
        self.ms.observe((time.perf_counter() - t0) * 1e3)
        return out, flash_fwd.launches - before

    def consume(self, queue, n: int):
        self.calls.inc(1.0, tags={"method": "consume"})
        return [queue.get(timeout=120) for _ in range(n)]


def phase_trace_metrics(smi):
    """With tracing on, a driver span submits a card task (the flash
    forward) that submits a nested task: one trace, driver -> task ->
    nested task, rendered and exported as OTLP/JSON.  ActorPool.map over
    two card actors, each the flash forward on its share of a batch,
    equal to the driver's own call.  A Queue between a producer task and
    a consumer actor.  A util.metrics server on a free localhost port,
    scraped over HTTP for the actors' Counter and Histogram."""
    import urllib.request

    import torch
    import ray_tpu_torch as rtt
    from ray_tpu_torch.ops.attention import flash_fwd
    from ray_tpu_torch.util import ActorPool, Queue, metrics, tracing
    t0 = time.perf_counter()
    out = {"phase": "trace_metrics", "card": smi}
    rtt.init(num_cpus=4)
    try:
        shards = [rtt.remote(CardShard).options(
            device="cuda", num_cpus=0, max_concurrency=2).remote()
            for _ in range(2)]
        tracing.enable()
        try:
            with tracing.span("driver"):
                trace_id = tracing.current().trace_id
                traced = rtt.get(rtt.remote(num_tpus=1)(
                    traced_card_task).remote(5), timeout=600)
        finally:
            tracing.disable()
        text = tracing.render_trace(trace_id)
        names = [line.strip().split(" [")[0] for line in
                 text.splitlines()[1:]]
        where = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "_chip")
        os.makedirs(where, exist_ok=True)
        path = os.path.join(where, "trace_metrics_otlp.json")
        tracing.export_otlp_json(path, trace_id)
        with open(path) as f:
            otlp = json.load(f)
        spans = otlp["resourceSpans"][0]["scopeSpans"][0]["spans"]
        out["trace"] = {"trace_id": trace_id, "tree": names,
                        "otlp_spans": len(spans)}
        check(names == ["- driver", "- submit traced_card_task",
                        "- execute traced_card_task", "- submit trace_leaf",
                        "- execute trace_leaf"]
              and len(spans) == 5
              and {s["traceId"] for s in spans} == {trace_id}
              and traced["nested"] == 6,
              f"trace_metrics: trace {text} {traced}")
        # ActorPool over the two card actors.
        sh = SCHED_SHAPE
        q, k, v = _flash_inputs(4, sh["H"], sh["Hkv"], sh["S"], sh["S"],
                                sh["D"], torch.bfloat16, 11)
        mine, _ = flash_fwd(q, k, v, causal=True)
        shares = [(q[i:i + 2].cpu(), k[i:i + 2].cpu(), v[i:i + 2].cpu())
                  for i in (0, 2)]
        pool = ActorPool(shards)
        got = list(pool.map(lambda a, s: a.forward.remote(*s), shares))
        pooled = torch.cat([o for o, _n in got])
        err = (pooled.float() - mine.float().cpu()).abs().max().item()
        out["actor_pool"] = {"equal": bool(torch.equal(pooled, mine.cpu())),
                             "max_abs_err": err,
                             "launches": [n for _o, n in got]}
        check(out["actor_pool"]["equal"],
              f"trace_metrics: ActorPool's flash differs from the "
              f"driver's by {err}")
        # A Queue: a producer task, a consumer actor.
        queue = Queue(actor_options={"num_cpus": 0})
        consumed = shards[0].consume.remote(queue, 8)
        produced = rtt.remote(queue_producer).remote(queue, 8)
        out["queue"] = {"produced": rtt.get(produced, timeout=300),
                        "consumed": rtt.get(consumed, timeout=300)}
        queue.shutdown()
        check(out["queue"]["consumed"] == [i * i for i in range(8)],
              f"trace_metrics: queue {out['queue']}")
        # The metrics server, scraped over HTTP.
        port = metrics.start_metrics_server(0)
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/metrics", timeout=60) as resp:
                scraped = resp.read().decode()
        finally:
            metrics.stop_metrics_server()
        series = sorted(line for line in scraped.splitlines()
                        if line.startswith("smoke_shard"))
        out["metrics"] = {"port": port, "series": series}
        check('smoke_shard_calls_total{method="forward"} 2.0' in series
              and 'smoke_shard_calls_total{method="consume"} 1.0' in series
              and "smoke_shard_forward_ms_count 2.0" in series,
              f"trace_metrics: scraped {series}")
        for a in shards:
            rtt.kill(a)
    finally:
        rtt.shutdown()
    out["launches"] = {"flash_fwd": traced["launches"] + sum(
        n for _o, n in got)}
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return out["launches"]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs on the "
              "card", file=sys.stderr)
        return 1
    try:
        import ray_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from the root of a checkout (ray_tpu_torch "
              "not importable)", file=sys.stderr)
        return 1
    # fp32 matmuls and convolutions in full fp32 (no TF32) for the checks.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    info = phase_device()
    smi = info["nvidia_smi"]
    phase_build()
    phase_kernel_check()
    rows = phase_kernel_time(smi)
    phase_serve_exact()
    paths = {"serve": phase_serve(smi)}
    torch.cuda.empty_cache()
    paths["serve_sampled"] = phase_serve_sampled(smi)
    torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    paths["sync_tripwire"] = phase_sync_tripwire(smi)
    torch.cuda.empty_cache()
    paths["serve_tiny"] = phase_serve_tiny()
    paths["recompile"] = phase_recompile(smi)
    paths["paged_streams"] = phase_paged_streams()
    torch.cuda.empty_cache()
    phase_disagg_exact()
    torch.cuda.empty_cache()
    paths["disagg_load"], paths["fleet"], paths["lock_profile"] = \
        phase_serving_tiers(smi)
    torch.cuda.empty_cache()
    paths["serve_deployment"] = phase_serve_deployment(smi)
    gc.collect()
    torch.cuda.empty_cache()
    paths["dag_disagg"] = phase_dag_disagg(smi)
    gc.collect()
    torch.cuda.empty_cache()
    phase_handoff_ipc(smi)
    gc.collect()
    torch.cuda.empty_cache()
    paths["fleet_remote"] = phase_fleet_remote(smi)
    gc.collect()
    torch.cuda.empty_cache()
    paths["serve_controller"] = phase_serve_controller(smi)
    gc.collect()
    torch.cuda.empty_cache()
    paths["sanitize"] = phase_sanitize(smi)
    gc.collect()
    torch.cuda.empty_cache()
    paths["trace_metrics"] = phase_trace_metrics(smi)
    torch.cuda.empty_cache()
    phase_train_exact()
    paths["train_tiny"] = phase_train_tiny()
    paths["train"], params, opt = phase_train(smi)
    paths["train_dots"] = phase_train_dots(smi, params, opt)
    del params, opt
    torch.cuda.empty_cache()
    paths["data_train"] = phase_data_train(smi)
    torch.cuda.empty_cache()
    paths["checkpoint"] = phase_checkpoint(smi)
    torch.cuda.empty_cache()
    paths["trainer"] = phase_trainer(smi)
    torch.cuda.empty_cache()
    paths["sched_cards"] = phase_sched_cards(smi)
    paths["tune"] = phase_tune(smi)
    torch.cuda.empty_cache()
    paths["ring_local"] = phase_ring_local(smi)
    torch.cuda.empty_cache()
    paths["train_moe"] = phase_train_moe(smi)
    torch.cuda.empty_cache()
    t_rl = time.perf_counter()
    phase_rl_exact(smi)
    phase_rl_train(smi)
    emit({"phase": "rl", "card": smi,
          "seconds": time.perf_counter() - t_rl})
    phase_rl_remote(smi)
    phase_collective(smi)
    kernels = []
    for name, row, src, rep in (
            ("flash_fwd", rows["flash_fwd_S256"], FLASH_SOURCE,
             FLASH_REPLACES),
            ("paged_decode", rows["paged_decode"], PAGED_SOURCE,
             PAGED_REPLACES),
            ("flash_bwd_dq", rows["flash_bwd_dq"], BWD_SOURCE, DQ_REPLACES),
            ("flash_bwd_dkv", rows["flash_bwd_dkv"], BWD_SOURCE,
             DKV_REPLACES)):
        by_path = {p: n[name] for p, n in paths.items() if name in n}
        check(all(by_path.values()),
              f"{name} was not launched on every path that runs it: "
              f"{by_path}")
        kernels.append(dict(
            {"name": name, "route": "cuda", "source": src, "replaces": rep,
             "launches": sum(by_path.values()),
             "launches_by_path": by_path,
             "at_d32": _line_numbers(rows[f"{name}_d32"])},
            **_line_numbers(row)))
    # Each attention kernel where training spends its time, beside its
    # B=1 row; the paged kernel's other timed shapes beside serving's.
    for entry in kernels:
        if entry["name"].startswith("flash"):
            entry["at_train_shape"] = _line_numbers(
                rows[f"{entry['name']}_train"])
        elif entry["name"] == "paged_decode":
            entry["at_shapes"] = {key: _line_numbers(rows[key])
                                  for key, *_ in PAGED_SHAPES[1:]}
    emit({"kernels": kernels, "card": smi,
          "seconds": time.perf_counter() - t_start})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
