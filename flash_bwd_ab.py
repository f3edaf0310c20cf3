#!/usr/bin/env python3
"""Time the bf16 flash backward (dq and dk/dv kernels) of several checkouts
against each other on one NVIDIA card, in one process.

    python3 flash_bwd_ab.py ROOT [ROOT ...]

Each ROOT is the root of a checkout (or of an unpacked ``git archive``) that
holds ``ray_tpu_torch/``.  Each tree's package is imported under a name of
its own, builds its ``flash_bwd`` library inside the tree, and is called
through its own Python wrappers.  At B1 H16 Hkv16, B1 H16 Hkv8 and the
training step's B12 H16 Hkv16 (S 2048, D 128, causal, bf16) the trees and
SDPA's backward take turns, in an order that rotates every round, for
ROUNDS rounds of:

- ``graph_ms``: device time, by replay of a CUDA graph of ten calls (five
  at B12);
- ``eager_ms``: back-to-back calls of the Python wrapper, timed with CUDA
  events, host cost included.

For each tree three calls are timed: ``dq`` (``flash_bwd_dq``), ``dkv``
(``flash_bwd_dkv``) and ``pair`` (``flash_bwd``: both kernels and whatever
the tree does around them).  A tree whose ``flash_bwd_dq`` takes ``delta``
(delta = rowsum(dO * O) computed outside the kernels) gets it computed once
before the timed calls; a tree whose dq kernel computes delta itself returns
it with dq, and its dk/dv kernel reads that.  SDPA is timed as one
``autograd.grad`` through the backward of the backend it picks (its name is
printed).  Every tree's gradients are held against its own plain version
(max abs error over the largest magnitude, and the worst row's
||a - b|| / ||b||).  Prints the card's name and power limit, then one JSON
line per shape: for each tree (and SDPA) the median and the least of each
number over the rounds.
"""

from __future__ import annotations

import inspect
import json
import math
import os
import statistics
import sys

SHAPES = (("B1", (1, 16, 16, 2048, 128), 30),
          ("B1_gqa16_8", (1, 16, 8, 2048, 128), 30),
          ("train", (12, 16, 16, 2048, 128), 5))
ROUNDS = 7


def tree_calls(attn, q, k, v, out, lse, dout):
    """{"dq", "dkv", "pair"} -> a call of the tree's wrappers."""
    kw = dict(causal=True, scale=q.shape[-1] ** -0.5, q_offset=0)
    if "delta" in inspect.signature(attn.flash_bwd_dq).parameters:
        delta = (dout.float() * out.float()).sum(-1)
        dq = lambda: attn.flash_bwd_dq(q, k, v, dout, lse, delta, **kw)
    else:
        dq = lambda: attn.flash_bwd_dq(q, k, v, out, dout, lse, **kw)
        delta = dq()[1]
    return {"dq": dq,
            "dkv": lambda: attn.flash_bwd_dkv(q, k, v, dout, lse, delta,
                                              **kw),
            "pair": lambda: attn.flash_bwd(q, k, v, out, lse, dout,
                                           causal=True)}


def main(roots) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import torch

    from chip_smoke import (BWD_ROW_FLOOR, _bwd_inputs, _grad_errs,
                            graph_ms, row_rel_err, sdpa_bwd, time_ms)
    from ray_tpu_torch._device import card_power_line
    print(card_power_line(0), flush=True)
    from flash_fwd_ab import load_tree
    trees = [(os.path.abspath(r),
              load_tree(os.path.abspath(r), f"ab{i}_rtt", "flash_bwd")[0])
             for i, r in enumerate(roots)]
    for key, (B, H, Hkv, S, D), iters in SHAPES:
        q, k, v, out, lse, dout = _bwd_inputs(B, H, Hkv, S, S, D,
                                              torch.bfloat16, True, 0, 11)
        calls, errs = {}, {}
        for root, attn in trees:
            got = attn.flash_bwd(q, k, v, out, lse, dout, causal=True)
            ref = attn._flash_bwd_plain(q, k, v, out, lse, dout, True,
                                        1.0 / math.sqrt(D), 0)
            errs[root] = {
                g: {"max_rel_err": _grad_errs(a, r)[1],
                    "row_rel_err": row_rel_err(a, r, BWD_ROW_FLOOR)}
                for g, a, r in zip(("dq", "dk", "dv"), got, ref)}
            del got, ref
            for what, call in tree_calls(attn, q, k, v, out, lse,
                                         dout).items():
                calls[(root, what)] = call
        sdpa, backend = sdpa_bwd(q, k, v, dout)
        calls[("sdpa", "backward")] = sdpa
        names = list(calls)
        readings = {n: {"graph_ms": [], "eager_ms": []} for n in names}
        for rnd in range(ROUNDS):
            for n in names[rnd % len(names):] + names[:rnd % len(names)]:
                readings[n]["graph_ms"].append(
                    graph_ms(calls[n], calls=5 if B > 1 else 10))
                readings[n]["eager_ms"].append(time_ms(calls[n], iters))
        line = {"shape": key, "B": B, "H": H, "Hkv": Hkv, "S": S, "D": D,
                "causal": True, "rounds": ROUNDS, "sdpa_backend": backend,
                "trees": {}}
        for (tree, what), rd in readings.items():
            entry = line["trees"].setdefault(tree, {})
            entry[what] = {f"{m}_{stat}": f(xs) for m, xs in rd.items()
                           for stat, f in (("median", statistics.median),
                                           ("min", min))}
            if tree in errs:
                entry["errors_vs_plain"] = errs[tree]
        print(json.dumps(line), flush=True)
        del q, k, v, out, lse, dout, calls, sdpa
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    if len(sys.argv) < 2 or sys.argv[1].startswith("-"):
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1:]))
