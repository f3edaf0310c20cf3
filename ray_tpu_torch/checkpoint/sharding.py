"""Index algebra for sharded checkpoints (a copy of
ray_tpu/checkpoint/sharding.py, which imports nothing of JAX; the port keeps
its own copy and imports nothing of ray_tpu).

An *index* is the slice of a global array one chunk covers, normalized to
``((start, stop), ...)`` with one pair per dimension.  The restore path
(``format._assemble``) intersects stored-chunk indexes with the requested
placement and copies overlapping regions; these helpers keep that logic
pure, boring and separately testable.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple

Index = Tuple[Tuple[int, int], ...]


def full_index(shape: Sequence[int]) -> Index:
    return tuple((0, int(d)) for d in shape)


def normalize_index(index: Any, global_shape: Sequence[int]) -> Index:
    """Accepts None (full), slices, (start, stop) pairs, or lists thereof."""
    if index is None:
        return full_index(global_shape)
    out = []
    for i, d in enumerate(global_shape):
        p = index[i] if i < len(index) else None
        if p is None:
            out.append((0, int(d)))
        elif isinstance(p, slice):
            start, stop, stride = p.indices(int(d))
            if stride != 1:
                raise ValueError(f"strided shard index unsupported: {p}")
            out.append((start, stop))
        else:
            start, stop = p
            out.append((int(start), int(stop)))
    return tuple(out)


def index_from_slices(slices: Sequence[slice],
                      global_shape: Sequence[int]) -> Index:
    """jax ``Shard.index`` (tuple of slices) -> normalized index."""
    return normalize_index(tuple(slices), global_shape)


def index_shape(index: Index) -> Tuple[int, ...]:
    return tuple(stop - start for start, stop in index)


def index_size(index: Index) -> int:
    n = 1
    for start, stop in index:
        n *= max(0, stop - start)
    return n


def intersect(a: Index, b: Index) -> Optional[Index]:
    """Overlapping region of two indexes, or None when disjoint/empty."""
    out = []
    for (a0, a1), (b0, b1) in zip(a, b):
        lo, hi = max(a0, b0), min(a1, b1)
        if lo >= hi:
            return None
        out.append((lo, hi))
    return tuple(out)


def copy_region(dst, dst_index: Index, src, src_index: Optional[Index],
                region: Index, fill: bool = False) -> None:
    """Copy ``region`` (global coordinates) from ``src`` (covering
    ``src_index``) into ``dst`` (covering ``dst_index``).  With
    ``fill=True``, set the region to True instead (coverage masks)."""
    dst_sel = tuple(slice(lo - d0, hi - d0)
                    for (lo, hi), (d0, _) in zip(region, dst_index))
    if fill:
        dst[dst_sel] = True
        return
    src_sel = tuple(slice(lo - s0, hi - s0)
                    for (lo, hi), (s0, _) in zip(region, src_index))
    dst[dst_sel] = src[src_sel]


def even_shard(global_shape: Sequence[int], axis: int, rank: int,
               world: int) -> Index:
    """Rank ``rank``'s contiguous block of ``axis`` split ``world`` ways
    (remainder spread over the leading ranks, torch-DistributedSampler
    style)."""
    dim = int(global_shape[axis])
    base, rem = divmod(dim, world)
    start = rank * base + min(rank, rem)
    stop = start + base + (1 if rank < rem else 0)
    out = list(full_index(global_shape))
    out[axis] = (start, stop)
    return tuple(out)


def even_shard_spec(axis: int, rank: int, world: int) -> Callable:
    """``shard_spec`` for ``snapshot_tree``: every array leaf is this
    rank's even block of ``axis`` of a global array that is ``world``
    times larger along that axis.

    The local leaf on each rank is its OWN slice; the declared global
    shape scales the sharded axis back up.  Use with training loops where
    each rank materializes only its rows (e.g. optimizer state sharding).
    """
    def spec(key: str, leaf) -> Tuple[Tuple[int, ...], Index]:
        local = tuple(int(d) for d in leaf.shape)
        if not local:
            # Scalars cannot shard; declare them replicated (full index).
            return local, full_index(local)
        dim = local[axis] * world
        global_shape = local[:axis] + (dim,) + local[axis + 1:]
        idx = even_shard(global_shape, axis, rank, world)
        if index_shape(idx) != local:
            raise ValueError(
                f"leaf {key!r}: local shape {local} is not rank {rank}'s "
                f"even block of global {global_shape}")
        return global_shape, idx
    return spec


def even_placement(axis: int, rank: int, world: int) -> Callable:
    """``placement`` for ``restore_tree``: fetch this rank's even block
    of ``axis`` (the resharding-restore dual of ``even_shard_spec``)."""
    def placement(key: str, global_shape: Sequence[int]) -> Optional[Index]:
        if not global_shape:
            return None
        return even_shard(global_shape, axis, rank, world)
    return placement
