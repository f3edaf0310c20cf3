"""Streaming executor: blocks flow through fused task stages with bounded
in-flight backpressure; all-to-all stages run as distributed two-stage
map/reduce shuffles over tasks (counterpart of ray_tpu/data/executor.py).

With a session up (``ray_tpu_torch.init()``) every stage runs as the
port's tasks (``_tasks``): a block is a store ref, and its payload moves
worker to worker through shared memory, never through the driver, which
maps a block only where it consumes it (``fetch``).  Without one, each
stage runs in the driver (the branches under ``not is_initialized()``,
as JAX's).  A failed task raises; nothing falls back to the driver.

Everything shipped to a worker goes by reference (the port has no
cloudpickle): the stage functions are top-level functions or
``functools.partial`` of them, and a user's function inside a stage must
be defined at the top level of a module too (``Dataset.map_batches``).

Reference analog: _internal/execution/streaming_executor.py:76 (scheduling
loop :423) + operator fusion rules (_internal/logical/rules/) +
backpressure policies (_internal/execution/backpressure_policy/); the
shuffle mirrors _internal/planner/exchange/ (map tasks partition their
block into N outputs, reduce tasks merge partition j from every map task).

Block format note: numpy dict blocks are the default;
``DataContext.block_format = "arrow"`` flows pyarrow Tables through these
same stages instead (zero-copy scans/slices, numpy only at the consumer
boundary).  Stage code touches blocks through BlockAccessor (which
dispatches on the physical layout), never raw dict operations.
"""

from __future__ import annotations

import hashlib
import time
from typing import Any, Callable, Iterator, List, Optional

import numpy as np

from .block import Block, BlockAccessor

# Fallback in-flight cap where no per-operator policy instance exists
# (driver-local paths); streaming stages use _OpBackpressure below.
MAX_IN_FLIGHT = 8
#: Seconds the executor waits for one task before it raises.
TASK_TIMEOUT_S = 600


class _OpBackpressure:
    """Per-operator in-flight window, sized from observed block bytes
    against the context memory budget (reference:
    _internal/execution/backpressure_policy/ — per-op resource budgets
    instead of one global constant)."""

    def __init__(self):
        from .context import DataContext
        self._ctx = DataContext.get()
        self._ema: float = 0.0

    def note_block(self, ref) -> None:
        nbytes = _block_nbytes(ref)
        if nbytes:
            self._ema = nbytes if not self._ema else \
                0.7 * self._ema + 0.3 * nbytes

    def window(self) -> int:
        ctx = self._ctx
        if not self._ema:
            return ctx.initial_in_flight
        w = int(ctx.op_memory_budget_bytes // max(self._ema, 1.0))
        return max(ctx.min_in_flight, min(ctx.max_in_flight, w))


def _block_nbytes(ref) -> int:
    """Size of a ready block from its ref's store descriptor (0 for a
    block in memory or a ref still running)."""
    from .._actor import ObjectRef
    from .._tasks import desc_nbytes
    if not isinstance(ref, ObjectRef) or not ref._store \
            or not ref._fut.done() or ref._fut.exception() is not None:
        return 0
    return desc_nbytes(ref._fut.result())


def _note_op_block(operator: str, t0: float, block) -> None:
    """Built-in data-pipeline metrics for one processed block (in a worker
    they reach the driver with the task's result, through
    ``telemetry.merge_remote``)."""
    try:
        from ..util import telemetry
        rows = BlockAccessor(block).num_rows()
    except Exception:
        return
    tags = {"operator": operator}
    telemetry.observe("ray_tpu_data_block_seconds",
                      time.perf_counter() - t0, tags=tags)
    telemetry.inc("ray_tpu_data_blocks_total", tags=tags)
    if rows:
        telemetry.inc("ray_tpu_data_rows_total", rows, tags=tags)


def _is_read_marker(b) -> bool:
    return isinstance(b, tuple) and len(b) == 3 and b[0] == "__read__"


def _apply_chain(fns, block_or_read):
    """Worker-side: resolve a read marker, then run the fused stage chain."""
    is_read = _is_read_marker(block_or_read)
    t0 = time.perf_counter()
    if is_read:
        _tag, loader, path = block_or_read
        block = loader(path)
    else:
        block = block_or_read
    for fn in fns:
        block = fn(block)
    if fns or is_read:  # bare pass-throughs (fetch) aren't operator work
        _note_op_block("map", t0, block)
    return block


def _split_block(seed: Optional[int], n_out: int, randomize: bool,
                 block_or_read):
    """Shuffle map side: partition this block's rows into n_out pieces
    (random assignment for shuffle, contiguous for repartition)."""
    block = _apply_chain([], block_or_read)
    acc = BlockAccessor(block)
    n = acc.num_rows()
    if randomize:
        rng = np.random.default_rng(seed)
        assignment = rng.integers(0, n_out, n)
    else:
        assignment = (np.arange(n) * n_out) // max(n, 1)
    parts = [acc.take(np.nonzero(assignment == j)[0]) for j in range(n_out)]
    return tuple(parts) if n_out > 1 else parts[0]


def _map_side(seed_i, n, rand, fns, block_or_read):
    """The shuffle's map task: the fused chain, then the split (JAX's
    nested ``map_side``, here at the top level so it ships by
    reference)."""
    return _split_block(seed_i, n, rand, _apply_chain(fns, block_or_read))


def _merge_parts(seed: Optional[int], randomize: bool, *parts):
    """Shuffle reduce side: merge partition j from every map task."""
    t0 = time.perf_counter()
    merged = BlockAccessor.concat(list(parts))
    if not merged and parts:
        # All parts empty: keep the schema (zero-row columns), don't
        # degrade to a column-less block.
        merged = parts[0]
    if randomize:
        acc = BlockAccessor(merged)
        rng = np.random.default_rng(seed)
        merged = acc.take(rng.permutation(acc.num_rows()))
    _note_op_block("reduce", t0, merged)
    return merged


def fetch(block_or_ref) -> Block:
    from .._actor import ObjectRef, get
    if isinstance(block_or_ref, ObjectRef):
        return get(block_or_ref, timeout=TASK_TIMEOUT_S)
    if _is_read_marker(block_or_ref):
        return _apply_chain([], block_or_ref)
    return block_or_ref


def _session_up() -> bool:
    from .._tasks import is_initialized
    return is_initialized()


def _remote(fn, **options):
    from .._tasks import RemoteFunction
    return RemoteFunction(fn, **options)


def _wait_first(refs, ordered: bool):
    """The oldest ref once ready (``ordered``), else the first of ``refs``
    to be ready; raises after ``TASK_TIMEOUT_S``."""
    from .._actor import GetTimeoutError, wait
    ready, _ = wait(refs[:1] if ordered else refs, num_returns=1,
                    timeout=TASK_TIMEOUT_S)
    if not ready:
        raise GetTimeoutError(f"no data task finished in {TASK_TIMEOUT_S} s")
    return ready[0]


def execute(ds) -> List[Any]:
    """Run the dataset's plan; returns a list of blocks/ObjectRefs."""
    return list(execute_streaming(ds))


def execute_streaming(ds, ordered: bool = True) -> Iterator[Any]:
    """Generator of output blocks/refs: map stages stream block-by-block
    (a consumer can iterate results while later blocks still compute);
    all-to-all stages are task-level shuffles whose outputs stream too.

    ``ordered=False`` (iteration paths, when DataContext.preserve_order is
    off) yields whichever block completes first so a slow task never
    head-of-line-blocks the consumer.  A plan of reads and nothing else
    hands its read markers on as they are, so each is read where it is
    consumed (``fetch``), as JAX's executor does."""
    blocks: List[Any] = list(ds._source)
    stages = list(ds._stages)
    while stages:
        fused: List[Callable] = []
        while stages and stages[0].kind == "map":
            fused.append(stages.pop(0).fn)
        if stages:
            # Barrier ahead: the shuffle's map side fuses the pending map
            # chain, so blocks go source -> [maps+split] in one task.
            barrier = stages.pop(0)
            blocks = _run_shuffle(blocks, fused, barrier)
        elif fused or _has_read_markers(blocks):
            yield from _stream_fused(blocks, fused, ordered=ordered)
            return
        else:
            break
    yield from blocks


def _has_read_markers(blocks: List[Any]) -> bool:
    return any(_is_read_marker(b) for b in blocks)


def _stream_fused(blocks: List[Any], fns: List[Callable],
                  ordered: bool = True) -> Iterator[Any]:
    """Submit fused block tasks with a bounded window, yielding refs as
    they complete — consumption overlaps production.  ``ordered=False``
    yields first-completed (reference: streaming_executor.py:423 dispatches
    eagerly; preserve_order=False is the execution-options default)."""
    if not _session_up():
        for b in blocks:
            yield _apply_chain(fns, fetch(b))
        return

    apply_remote = _remote(_apply_chain)
    bp = _OpBackpressure()
    pending: List[Any] = []
    idx = 0
    while idx < len(blocks) or pending:
        while idx < len(blocks) and len(pending) < bp.window():
            pending.append(apply_remote.remote(fns, blocks[idx]))
            idx += 1
        done = _wait_first(pending, ordered)
        pending.remove(done)
        bp.note_block(done)
        yield done


def _run_shuffle(blocks: List[Any], fused: List[Callable], stage
                 ) -> List[Any]:
    """Distributed two-stage shuffle: N map tasks partition, M reduce tasks
    merge — data moves through the store, never the driver.  The map
    side's parts are held only by the merge tasks that read them, so each
    goes once its merge has run."""
    from .._actor import wait

    kind = stage.kind
    if kind.startswith("sort:") or kind.startswith("groupshuffle:"):
        return _run_key_exchange(blocks, fused, stage)
    if kind.startswith("shuffle"):
        seed_s = kind.split(":", 1)[1]
        seed = None if seed_s == "None" else int(seed_s)
        randomize = True
        n_out = max(1, len(blocks))
    elif kind.startswith("repartition"):
        seed = None
        randomize = False
        n_out = int(kind.split(":", 1)[1])
    else:
        raise ValueError(f"unknown barrier stage {kind}")

    if not _session_up():
        # Driver-local fallback for pure in-process use.
        materialized = [_apply_chain(fused, fetch(b)) for b in blocks]
        full = BlockAccessor.concat(materialized)
        n_rows = BlockAccessor(full).num_rows()
        if randomize:
            rng = np.random.default_rng(seed)
            full = BlockAccessor(full).take(rng.permutation(n_rows))
        bounds = np.linspace(0, n_rows, n_out + 1, dtype=np.int64)
        return [BlockAccessor(full).slice(int(a), int(b))
                for a, b in zip(bounds[:-1], bounds[1:])]

    if not randomize:
        return _repartition_tasks(blocks, fused, n_out)

    split_remote = _remote(_map_side, num_returns=n_out)
    bp = _OpBackpressure()
    parts: List[List[Any]] = []
    for i, b in enumerate(blocks):
        # Windowed submission (per-operator backpressure): throttle
        # map-task *execution*; the N*n_out part objects still
        # accumulate, which is inherent to an all-to-all exchange.
        w = bp.window()
        if i >= w:
            wait([parts[i - w][0]], num_returns=1, timeout=TASK_TIMEOUT_S)
            bp.note_block(parts[i - w][0])
        s = None if seed is None else seed + i
        refs = split_remote.remote(s, n_out, randomize, fused, b)
        parts.append(refs if isinstance(refs, list) else [refs])

    merge_remote = _remote(_merge_parts)
    out = []
    for j in range(n_out):
        s = None if seed is None else seed + 100003 + j
        out.append(merge_remote.remote(
            s, randomize, *[parts[i][j] for i in range(len(parts))]))
    return out


# -- key exchanges: sort (range partition) + groupby (hash partition) ------

def _stable_hash_mod(values: np.ndarray, n: int) -> np.ndarray:
    """Deterministic cross-process bucket assignment.  NEVER builtins
    hash(): PYTHONHASHSEED differs per worker, which would scatter one
    key across reducers."""
    uniq, inv = np.unique(values, return_inverse=True)
    buckets = np.array([
        int.from_bytes(hashlib.blake2b(repr(u).encode(),
                                       digest_size=8).digest(), "little") % n
        for u in uniq.tolist()], dtype=np.int64)
    return buckets[inv]


def _sample_keys(key: str, k: int, fns, block_or_read) -> np.ndarray:
    block = BlockAccessor(_apply_chain(fns, block_or_read)).to_numpy()
    keys = block.get(key)
    if keys is None or len(keys) == 0:
        return np.array([])
    idx = np.linspace(0, len(keys) - 1, min(k, len(keys)), dtype=np.int64)
    return keys[idx]


def _key_split(key: str, boundaries, n_out: int, fns, block_or_read):
    """Exchange map side: partition rows by sort-range or key-hash."""
    block = _apply_chain(fns, block_or_read)
    acc = BlockAccessor(block)
    if acc.num_rows() == 0:
        parts = [block] * n_out
    else:
        keys = acc.to_numpy()[key]
        if boundaries is None:
            assignment = _stable_hash_mod(keys, n_out)
        else:
            assignment = np.searchsorted(np.asarray(boundaries), keys,
                                         side="right")
        parts = [acc.take(np.nonzero(assignment == j)[0])
                 for j in range(n_out)]
    return tuple(parts) if n_out > 1 else parts[0]


def _merge_key_parts(key: str, descending: bool, do_sort: bool, *parts):
    t0 = time.perf_counter()
    merged = BlockAccessor.concat(list(parts))
    if not merged and parts:
        merged = parts[0]
    if do_sort and merged and BlockAccessor(merged).num_rows():
        order = np.argsort(merged[key], kind="stable")
        if descending:
            order = order[::-1]
        merged = BlockAccessor(merged).take(order)
    _note_op_block("reduce", t0, merged)
    return merged


def _run_key_exchange(blocks: List[Any], fused: List[Callable], stage
                      ) -> List[Any]:
    """Sort: sample -> range boundaries -> partition -> sorted merge
    (global order = block order; reference: planner/exchange sort).
    Groupby: hash partition so each key lands wholly in one block."""
    from .._actor import get, wait

    kind, key, *rest = stage.kind.split(":")
    descending = bool(rest) and rest[0] == "1"
    n_out = max(1, len(blocks))

    if not _session_up():
        materialized = [_apply_chain(fused, fetch(b)) for b in blocks]
        full = BlockAccessor.concat(materialized)
        if kind == "sort" and full and BlockAccessor(full).num_rows():
            order = np.argsort(full[key], kind="stable")
            if descending:
                order = order[::-1]
            full = BlockAccessor(full).take(order)
        return [full]

    boundaries = None
    if kind == "sort":
        sample_remote = _remote(_sample_keys)
        samples = get([sample_remote.remote(key, 64, fused, b)
                       for b in blocks], timeout=TASK_TIMEOUT_S)
        all_keys = np.sort(np.concatenate(
            [s for s in samples if len(s)] or [np.array([0])]))
        qs = np.linspace(0, len(all_keys) - 1, n_out + 1)[1:-1]
        boundaries = all_keys[qs.astype(np.int64)]
        # Descending: partition ascending, reducers sort descending, and
        # the block order is reversed at the end.

    split_remote = _remote(_key_split, num_returns=n_out)
    bp = _OpBackpressure()
    parts: List[List[Any]] = []
    for i, b in enumerate(blocks):
        w = bp.window()
        if i >= w:
            wait([parts[i - w][0]], num_returns=1, timeout=TASK_TIMEOUT_S)
            bp.note_block(parts[i - w][0])
        refs = split_remote.remote(key, boundaries, n_out, fused, b)
        parts.append(refs if isinstance(refs, list) else [refs])

    merge_remote = _remote(_merge_key_parts)
    out = [merge_remote.remote(key, descending, kind == "sort",
                               *[parts[i][j] for i in range(len(parts))])
           for j in range(n_out)]
    if kind == "sort" and descending:
        out.reverse()
    return out


def _count_rows(block_or_read) -> int:
    return BlockAccessor(_apply_chain([], block_or_read)).num_rows()


def _slice_concat(ranges, *blocks):
    """ranges[i] = (start, stop) into blocks[i]; concat preserves order."""
    pieces = [BlockAccessor(b).slice(int(a), int(z))
              for b, (a, z) in zip(blocks, ranges)]
    out = BlockAccessor.concat(pieces)
    return out if out or not pieces else pieces[0]


def _repartition_tasks(blocks: List[Any], fused: List[Callable],
                       n_out: int) -> List[Any]:
    """Order-preserving distributed repartition: run the fused chain,
    count rows per block (metadata only to the driver), then slice+concat
    tasks assemble contiguous global ranges (reference:
    Dataset.repartition(shuffle=False) split/coalesce semantics)."""
    from .._actor import get

    mapped = list(_stream_fused(blocks, fused)) if fused or \
        _has_read_markers(blocks) else blocks
    count_remote = _remote(_count_rows)
    counts = get([count_remote.remote(b) for b in mapped],
                 timeout=TASK_TIMEOUT_S)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    total = int(offsets[-1])
    bounds = np.linspace(0, total, n_out + 1, dtype=np.int64)
    slice_remote = _remote(_slice_concat)
    out = []
    for a, z in zip(bounds[:-1], bounds[1:]):
        needed = []
        ranges = []
        for i, b in enumerate(mapped):
            lo, hi = offsets[i], offsets[i + 1]
            s0, s1 = max(a, lo), min(z, hi)
            if s1 > s0 or (not needed and z == a and lo <= a < hi):
                needed.append(b)
                ranges.append((s0 - lo, max(s1 - lo, s0 - lo)))
        if not needed and mapped:
            needed = [mapped[0]]
            ranges = [(0, 0)]
        out.append(slice_remote.remote(ranges, *needed))
    return out
