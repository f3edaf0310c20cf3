#!/usr/bin/env python3
"""Time the bf16 paged decode kernel of several checkouts against each
other on one NVIDIA card, in one process.

    python3 paged_decode_ab.py ROOT [ROOT ...]

Each ROOT is the root of a checkout (or of an unpacked ``git archive``) that
holds ``ray_tpu_torch/``.  Each tree's package is imported under a name of
its own (``flash_fwd_ab.load_tree``), builds its ``paged_decode`` library
inside the tree, and is called through its own Python wrapper.  At each of
``chip_smoke.PAGED_SHAPES`` (H 16 / Hkv 8 or 32 / 32, D 128, page 16, the
engine's table width P = 128, caches rotated past the L2) and at a
host-bound shape (B 1, length 16, two copies) the trees take turns, in an
order that rotates every round, for ROUNDS rounds of:

- ``graph_ms``: device time, by replay of a CUDA graph of at least ten
  calls;
- ``eager_ms``: back-to-back calls of the Python wrapper, timed with CUDA
  events, host cost included;
- ``host_us``: host time of one call of the C entry point
  ``rt_paged_decode`` alone, through ctypes, without the wrapper's Python
  (100 calls).

Every tree's output is held against its own plain version (max abs error
and the worst live row's ||out - ref|| / ||ref||).  Prints the card's name
and power limit, then one JSON line per shape: for each tree the median and
the least of each number over the rounds.
"""

from __future__ import annotations

import importlib
import json
import math
import os
import statistics
import sys

HOST_SHAPE = ("host_B1_len16", 1, 16, 8, (16, 16), 1)
ROUNDS = 7
PAGE = 16


def c_call(mod, build, q, kv, bt, sl, out):
    """(the tree's rt_paged_decode, its arguments for this call): a tree
    with ``_kernel_args`` builds them itself (split count, workspace);
    an older one takes (q, kv, bt, sl, out, dtype, B, H, Hkv, D, P, page,
    scale, stream)."""
    import torch
    if hasattr(mod, "_kernel_args"):
        return mod._kernel_fn(), mod._kernel_args(q, kv, bt, sl, PAGE, out)
    B, H, D = q.shape
    return (build._fns[("paged_decode", "rt_paged_decode")],
            (q.data_ptr(), kv.data_ptr(), bt.data_ptr(), sl.data_ptr(),
             out.data_ptr(), 1, B, H, kv.shape[2] // 2, D, bt.shape[1], PAGE,
             1.0 / math.sqrt(D), torch.cuda.current_stream().cuda_stream))


def main(roots) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import torch

    from chip_smoke import (PAGED_SHAPES, graph_ms, paged_shape_inputs,
                            rotating, row_rel_err, time_ms)
    from flash_fwd_ab import host_us, load_tree
    from ray_tpu_torch._device import card_power_line
    print(card_power_line(0), flush=True)
    trees = []
    for i, r in enumerate(roots):
        alias = f"ab{i}_rtt"
        build = load_tree(os.path.abspath(r), alias, "paged_decode")[1]
        mod = importlib.import_module(f"{alias}.ops.paged_attention")
        trees.append((os.path.abspath(r), mod, build))
    for key, B, H, Hkv, lens_range, n_live in PAGED_SHAPES + (HOST_SHAPE,):
        copies, lens = paged_shape_inputs(
            B, H, Hkv, lens_range, n_live, seed=200,
            copies=2 if key == HOST_SHAPE[0] else None)
        q, kv, bt, sl = copies[0]
        live = sl > 0
        out = torch.empty_like(q)
        runs = {}
        for root, mod, build in trees:
            def kernel(q, kv, bt, sl, mod=mod):
                return mod.paged_decode(q, kv, bt, sl, PAGE)
            got = kernel(q, kv, bt, sl)
            ref = mod._exact_path(q, kv, bt, sl, PAGE)
            runs[root] = {
                "call": rotating(kernel, copies),
                "c": c_call(mod, build, q, kv, bt, sl, out),
                "max_abs_err": (got[live].float() - ref[live].float())
                .abs().max().item(),
                "row_rel_err": row_rel_err(got[live], ref[live])}
        calls = len(copies) * math.ceil(10 / len(copies))
        names = list(runs)
        readings = {n: {"graph_ms": [], "eager_ms": [], "host_us": []}
                    for n in names}
        for rnd in range(ROUNDS):
            for n in names[rnd % len(names):] + names[:rnd % len(names)]:
                readings[n]["graph_ms"].append(
                    graph_ms(runs[n]["call"], calls=calls))
                readings[n]["eager_ms"].append(time_ms(runs[n]["call"], 200))
                fn, args = runs[n]["c"]
                readings[n]["host_us"].append(host_us(fn, args))
        line = {"shape": key, "B": B, "H": H, "Hkv": Hkv, "D": 128,
                "page": PAGE, "P": bt.shape[1],
                "seq_lens": [min(lens), max(lens)],
                "cache_copies": len(copies), "rounds": ROUNDS, "trees": {}}
        for n in names:
            line["trees"][n] = {
                f"{m}_{stat}": f(xs) for m, xs in readings[n].items()
                for stat, f in (("median", statistics.median), ("min", min))}
            line["trees"][n]["max_abs_err"] = runs[n]["max_abs_err"]
            line["trees"][n]["row_rel_err"] = runs[n]["row_rel_err"]
        print(json.dumps(line), flush=True)
        del copies, q, kv, bt, sl, out, runs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    if len(sys.argv) < 2 or sys.argv[1].startswith("-"):
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1:]))
