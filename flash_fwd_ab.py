#!/usr/bin/env python3
"""Time the bf16 flash forward of several checkouts against each other on
one NVIDIA card, in one process.

    python3 flash_fwd_ab.py ROOT [ROOT ...]

Each ROOT is the root of a checkout (or of an unpacked ``git archive``) that
holds ``ray_tpu_torch/``.  Each tree's package is imported under a name of
its own, builds its ``flash_fwd`` library inside the tree, and is called
through its own Python wrapper.  At each of the shapes of ``chip_smoke.py``'s
``kernel_time`` phase (B1 H16 Hkv8 S256 and S2048, and the training step's
B12 H16 Hkv16 S2048 with the LSE; D 128, causal, bf16) the trees and SDPA
take turns, in an order that rotates every round, for ROUNDS rounds of:

- ``graph_ms``: device time, by replay of a CUDA graph of ten calls;
- ``eager_ms``: back-to-back calls of the Python wrapper, timed with CUDA
  events: what an eager caller (serving's prefill) pays, host cost included;
- ``host_us``: host time of one call of the C entry point ``rt_flash_fwd``
  alone, through ctypes, without the wrapper's Python (100 calls).

Host costs drift with other load on the machine's CPU; taking turns within
one process puts every tree under the same drift.  Prints the card's name
and power limit, then one JSON line per shape: for each tree (and SDPA) the
median and the least of each number over the rounds.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import statistics
import sys
import time

SHAPES = (("S256", (1, 16, 8, 256, 128), 200, False),
          ("S2048", (1, 16, 8, 2048, 128), 50, False),
          ("train", (12, 16, 16, 2048, 128), 20, True))
ROUNDS = 7


def load_tree(root: str, alias: str, lib: str = "flash_fwd"):
    """``ray_tpu_torch.ops.attention`` of the tree at ``root``, imported as
    ``<alias>.ops.attention``, with its library ``lib`` built."""
    pkg = os.path.join(root, "ray_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    build = importlib.import_module(f"{alias}.ops._build")
    build.build([lib])
    return importlib.import_module(f"{alias}.ops.attention"), build


def host_us(fn, args, calls: int = 100) -> float:
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        code = fn(*args)
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    if code != 0:
        raise RuntimeError(f"the C entry point returned {code}")
    return us


def main(roots) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import torch
    import torch.nn.functional as F

    from chip_smoke import _flash_inputs, graph_ms, time_ms
    from ray_tpu_torch._device import card_power_line
    print(card_power_line(0), flush=True)
    trees = [(os.path.abspath(r), *load_tree(os.path.abspath(r), f"ab{i}_rtt"))
             for i, r in enumerate(roots)]
    for key, (B, H, Hkv, S, D), iters, lse in SHAPES:
        q, k, v = _flash_inputs(B, H, Hkv, S, S, D, torch.bfloat16, seed=7)
        ref = torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)
        o = torch.empty_like(q)
        ls = torch.empty((B, H, S), dtype=torch.float32, device="cuda")
        scratch = torch.zeros(1, dtype=torch.int32, device="cuda")
        runs = {}
        for root, attn, build in trees:
            def kernel(attn=attn):
                return attn.flash_fwd(q, k, v, causal=True, need_lse=lse)
            err = (kernel()[0].float() - ref.float()).abs().max().item()
            # The C entry point with the wrapper's arguments; a tree whose
            # rt_flash_fwd takes a device scratch int before the stream
            # gets one.
            fn = build._fns[("flash_fwd", "rt_flash_fwd")]
            args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    ls.data_ptr() if lse else None, 1, B, H, Hkv, S, S, D,
                    D ** -0.5, 1, 0]
            if len(fn.argtypes) == 17:
                args.append(scratch.data_ptr())
            args.append(torch.cuda.current_stream().cuda_stream)
            runs[root] = {"call": kernel, "c": (fn, args),
                          "max_abs_err_vs_sdpa": err}

        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)

        names = list(runs) + ["sdpa"]
        readings = {n: {"graph_ms": [], "eager_ms": [], "host_us": []}
                    for n in names}
        for rnd in range(ROUNDS):
            for n in names[rnd % len(names):] + names[:rnd % len(names)]:
                call = sdpa if n == "sdpa" else runs[n]["call"]
                readings[n]["graph_ms"].append(graph_ms(call))
                readings[n]["eager_ms"].append(time_ms(call, iters))
                if n != "sdpa":
                    readings[n]["host_us"].append(host_us(*runs[n]["c"]))
        line = {"shape": key, "B": B, "H": H, "Hkv": Hkv, "S": S, "D": D,
                "need_lse": lse, "rounds": ROUNDS, "trees": {}}
        for n in names:
            line["trees"][n] = {
                f"{m}_{stat}": f(xs) for m, xs in readings[n].items() if xs
                for stat, f in (("median", statistics.median), ("min", min))}
            if n != "sdpa":
                line["trees"][n]["max_abs_err_vs_sdpa"] = \
                    runs[n]["max_abs_err_vs_sdpa"]
        print(json.dumps(line), flush=True)
        del q, k, v, o, ls, ref, runs
    return 0


if __name__ == "__main__":
    if len(sys.argv) < 2 or sys.argv[1].startswith("-"):
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1:]))
