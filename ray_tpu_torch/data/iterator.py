"""Batch iteration and device feeding (counterpart of
ray_tpu/data/iterator.py).

``iter_batches`` cuts a ``Dataset`` (streamed through its executor, each
block fetched as it is consumed) or an iterable of blocks into batches.
``device_put_iterator`` keeps up to ``prefetch`` batches' host-to-card
copies in flight while the current step runs: each batch goes through
pinned host buffers, its copies issued ``non_blocking`` on a side stream,
and the consumer's stream waits on that batch's event before the batch is
handed out.
"""

from __future__ import annotations

import collections
from typing import Iterable, Iterator, Optional

import numpy as np

from .block import Block, BlockAccessor


def iter_batches(ds, *, batch_size: int = 256, drop_last: bool = False,
                 shuffle_seed: Optional[int] = None) -> Iterator[Block]:
    """Batches of ``batch_size`` rows across block boundaries from ``ds``,
    a ``Dataset`` or an iterable of blocks; ``shuffle_seed`` permutes each
    block's rows first."""
    carry: Optional[Block] = None
    rng = (np.random.default_rng(shuffle_seed)
           if shuffle_seed is not None else None)
    # A seeded shuffle must consume blocks in plan order to be
    # reproducible; otherwise first-completed order is fine (and faster).
    for block in map(_maybe_shuffle(rng),
                     _blocks_of(ds, force_ordered=rng is not None)):
        if carry is not None and BlockAccessor(carry).num_rows():
            block = BlockAccessor.concat([carry, block])
            carry = None
        acc = BlockAccessor(block)
        n = acc.num_rows()
        start = 0
        while n - start >= batch_size:
            yield acc.slice(start, start + batch_size)
            start += batch_size
        if start < n:
            carry = acc.slice(start, n)
    if carry is not None and BlockAccessor(carry).num_rows() and not drop_last:
        yield carry


def _blocks_of(ds, force_ordered: bool = False) -> Iterable[Block]:
    """A Dataset's blocks as its executor streams them (unless
    preserve_order is set, first-completed, so one slow block task never
    delays the first batch); any other iterable as it is."""
    from .dataset import Dataset
    if not isinstance(ds, Dataset):
        yield from ds
        return
    from .context import DataContext
    from .executor import execute_streaming, fetch
    ordered = force_ordered or DataContext.get().preserve_order
    for b in execute_streaming(ds, ordered=ordered):
        yield fetch(b)


def _maybe_shuffle(rng):
    def apply(block: Block) -> Block:
        if rng is None:
            return block
        acc = BlockAccessor(block)
        return acc.take(rng.permutation(acc.num_rows()))
    return apply


def device_put_iterator(batches: Iterable[Block], sharding=None,
                        prefetch: int = 2, device=None) -> Iterator:
    """Host batch dicts -> dicts of tensors on ``device`` (None: the card),
    ``prefetch`` batches ahead.  ``sharding``, a ``parallel.mesh.Mesh``,
    places each process's rows onto the mesh's data axes
    (``train.mesh.runtime.shard_batch_tree``) on the mesh's device.  On the
    CPU each batch is a copy that owns its bytes."""
    import torch

    from .._device import resolve_device
    dev = sharding.device if sharding is not None else resolve_device(device)
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def put(b):
        b = BlockAccessor(b).to_numpy()
        if stream is None:
            return {k: torch.from_numpy(np.array(v, copy=True))
                    for k, v in b.items()}, None
        host = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                for k, v in b.items()}
        with torch.cuda.stream(stream):
            out = {k: h.to(dev, non_blocking=True) for k, h in host.items()}
            event = torch.cuda.Event()
            event.record(stream)
        return out, event

    def ready(item):
        out, event = item
        if event is not None:
            cur = torch.cuda.current_stream(dev)
            cur.wait_event(event)
            for t in out.values():
                # Made on the side stream, used on this one: the caching
                # allocator must not hand the memory out before this
                # stream is done with it.
                t.record_stream(cur)
        if sharding is not None:
            from ..train.mesh.runtime import shard_batch_tree
            out = shard_batch_tree(out, sharding)
        return out

    q: collections.deque = collections.deque()
    it = iter(batches)
    for b in it:
        q.append(put(b))
        if len(q) >= prefetch:
            break
    while q:
        out = q.popleft()
        nxt = next(it, None)
        if nxt is not None:
            q.append(put(nxt))
        yield ready(out)
