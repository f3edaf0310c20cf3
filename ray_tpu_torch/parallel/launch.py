"""Run one function on every rank of a local ``torch.distributed`` world:
one process a rank, a ``file://`` rendezvous, a hard time limit.

    results = run_local(fn, world, rendezvous_dir, *args)

Each process initialises the process group (gloo by default, whose ranks
are CPU processes; under NCCL rank r takes card r), calls ``fn(rank, world,
*args)`` and sends back its result, which must pickle.  Every rank must
enter every collective ``fn`` makes.  A rank that raises fails the run with
its traceback; a run past ``timeout`` seconds is killed and raises.  The
rendezvous file lives in ``rendezvous_dir`` (fresh for each run), so runs
in parallel never share a port or a file.
"""

from __future__ import annotations

import os
import time
import traceback
from typing import Any, Callable, List


def _entry(fn, rank, world, path, backend, queue, args):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank)
        dist.init_process_group(backend, init_method=f"file://{path}",
                                rank=rank, world_size=world)
        try:
            queue.put((rank, True, fn(rank, world, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported to the parent
        queue.put((rank, False, traceback.format_exc()))


def run_local(fn: Callable, world: int, rendezvous_dir: str, *args: Any,
              backend: str = "gloo", timeout: float = 120.0) -> List[Any]:
    """``[fn(rank, world, *args) for each rank]`` from ``world`` processes
    (see the module docstring)."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    os.makedirs(rendezvous_dir, exist_ok=True)
    path = os.path.join(rendezvous_dir, f"rendezvous-{os.getpid()}-"
                                        f"{time.monotonic_ns()}")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, path, backend,
                                              queue, args), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    results, failures = {}, []
    try:
        while len(results) + len(failures) < world:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"run_local: {world - len(results)} rank(s) did not "
                    f"finish within {timeout} s")
            if queue.empty():
                if any(p.exitcode not in (None, 0) for p in procs):
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0)]
                    time.sleep(0.5)
                    if queue.empty():
                        raise RuntimeError(f"run_local: rank(s) {dead} "
                                           "died without a result")
                time.sleep(0.02)
                continue
            rank, ok, value = queue.get()
            if ok:
                results[rank] = value
            else:
                failures.append(f"rank {rank}:\n{value}")
                break
        if failures:
            raise RuntimeError("run_local: " + "\n".join(failures))
    finally:
        for p in procs:
            p.join(timeout=max(0.0, min(5.0, deadline - time.monotonic())))
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world)]
