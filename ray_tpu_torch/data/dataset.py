"""Dataset: lazy logical plan -> streamed execution over the port's tasks
(counterpart of ray_tpu/data/dataset.py).

Reference analog: python/ray/data/dataset.py:196 Dataset (logical plan
_internal/logical/, StreamingExecutor _internal/execution/
streaming_executor.py:76).  The plan here is a source + a chain of
block-transform stages; consecutive map-like stages fuse into one task
(the reference's operator-fusion rule), and execution streams blocks
through worker tasks with bounded in-flight backpressure (``executor``).

Stages and readers are top-level functions bound with
``functools.partial`` (JAX's are closures, which its cloudpickle ships):
the port's tasks pickle by reference.  So on the distributed path (after
``ray_tpu_torch.init()``) a function given to ``map``, ``map_batches``,
``flat_map``, ``filter``, ``add_column`` or ``map_groups`` must be
defined at the top level of a module; a lambda raises ``ValueError`` when
the plan runs.  Without a session every stage runs in the driver and any
callable does.
"""

from __future__ import annotations

import builtins as _builtins
import functools
import glob as _glob
import os
from dataclasses import dataclass
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Union)

import numpy as np

from .block import Block, BlockAccessor, _normalize


@dataclass
class Stage:
    name: str
    fn: Callable[[Block], Block]          # block -> block
    # map-like stages fuse; all-to-all stages (shuffle/repartition) barrier
    kind: str = "map"


def _identity(block: Block) -> Block:
    return block


def _fn_name(fn) -> str:
    return getattr(fn, "__name__", type(fn).__name__)


# -- stage bodies (top-level, so tasks ship them by reference) -------------


def _map_rows(fn, block: Block) -> Block:
    rows = [fn(r) for r in BlockAccessor(block).iter_rows()]
    return BlockAccessor.from_rows(rows)


def _map_batch(fn, batch_format: str, block: Block) -> Block:
    acc = BlockAccessor(block)
    if batch_format == "numpy":
        return fn(acc.to_numpy())
    if batch_format == "pyarrow":
        return fn(acc.to_arrow())
    return fn(block)


def _flat_map_rows(fn, block: Block) -> Block:
    rows = [o for r in BlockAccessor(block).iter_rows() for o in fn(r)]
    return BlockAccessor.from_rows(rows)


def _filter_rows(fn, block: Block) -> Block:
    acc = BlockAccessor(block)
    keep = np.array([bool(fn(r)) for r in acc.iter_rows()], dtype=bool)
    return acc.take(np.nonzero(keep)[0])


def _add_column(name: str, fn, block: Block) -> Block:
    out = dict(BlockAccessor(block).to_numpy())
    out[name] = np.asarray(fn(out))
    return out


def _select_columns(cols: List[str], block: Block) -> Block:
    b = BlockAccessor(block).to_numpy()
    missing = [c for c in cols if c not in b]
    if b and missing:
        raise KeyError(f"select_columns: missing {missing}")
    return {c: b[c] for c in cols if c in b}


def _drop_columns(drop: frozenset, block: Block) -> Block:
    b = BlockAccessor(block).to_numpy()
    return {k: v for k, v in b.items() if k not in drop}


def _rename_columns(mapping: Dict[str, str], block: Block) -> Block:
    b = BlockAccessor(block).to_numpy()
    names = [mapping.get(k, k) for k in b]
    if len(set(names)) != len(names):
        dup = {n for n in names if names.count(n) > 1}
        raise ValueError(
            f"rename_columns: duplicate target columns {sorted(dup)}")
    return {mapping.get(k, k): v for k, v in b.items()}


# -- file loaders (run inside read tasks) ----------------------------------


def _load_parquet(fmt: str, path: str) -> Block:
    import pyarrow.parquet as pq
    return BlockAccessor.from_arrow(pq.read_table(path), fmt)


def _load_csv(fmt: str, path: str) -> Block:
    import pyarrow.csv as pc
    return BlockAccessor.from_arrow(pc.read_csv(path), fmt)


def _load_json(fmt: str, path: str) -> Block:
    import pyarrow.json as pj
    return BlockAccessor.from_arrow(pj.read_json(path), fmt)


def _glob_paths(paths: Union[str, List[str]]) -> List[str]:
    if isinstance(paths, str):
        return sorted(_glob.glob(paths)) or [paths]
    return list(paths)


def _to_table(block_or_read):
    from . import executor
    block = executor._apply_chain([], block_or_read)
    return BlockAccessor(block).to_arrow()


class Dataset:
    """Lazy, immutable; transforms return new Datasets."""

    def __init__(self, source_blocks: List[Any], stages: List[Stage],
                 parallelism: int):
        # source_blocks: list of ObjectRefs, read markers or in-memory
        # Blocks
        self._source = source_blocks
        self._stages = stages
        self._parallelism = parallelism

    # ------------------------------------------------------------------ #
    # sources (reference: data/read_api.py)
    # ------------------------------------------------------------------ #

    @staticmethod
    def from_items(items: Sequence[Any], parallelism: int = 8) -> "Dataset":
        items = list(items)
        n = max(1, min(parallelism, len(items) or 1))
        chunks = np.array_split(np.arange(len(items)), n)
        blocks = []
        for c in chunks:
            rows = [_normalize(items[i]) for i in c]
            blocks.append(BlockAccessor.from_rows(rows))
        return Dataset(blocks, [], n)

    @staticmethod
    def range(n: int, parallelism: int = 8) -> "Dataset":
        bounds = np.linspace(0, n, max(1, parallelism) + 1, dtype=np.int64)
        blocks = [{"id": np.arange(a, b)} for a, b in
                  zip(bounds[:-1], bounds[1:]) if b > a]
        return Dataset(blocks, [], parallelism)

    @staticmethod
    def from_numpy(arrays: Dict[str, np.ndarray],
                   parallelism: int = 8) -> "Dataset":
        n = len(next(iter(arrays.values())))
        bounds = np.linspace(0, n, max(1, parallelism) + 1, dtype=np.int64)
        blocks = [{k: v[a:b] for k, v in arrays.items()}
                  for a, b in zip(bounds[:-1], bounds[1:]) if b > a]
        return Dataset(blocks, [], parallelism)

    @staticmethod
    def from_pandas(df, parallelism: int = 8) -> "Dataset":
        return Dataset.from_numpy(
            {c: df[c].to_numpy() for c in df.columns}, parallelism)

    @staticmethod
    def from_arrow(tables, parallelism: int = 8) -> "Dataset":
        """One or more pyarrow Tables -> Dataset (reference:
        ray.data.from_arrow / from_arrow_refs).  A single table splits
        into ``parallelism`` blocks; a list maps table-per-block —
        numeric columns convert zero-copy."""
        if not isinstance(tables, (list, tuple)):
            block = BlockAccessor.from_arrow(tables)
            if isinstance(block, dict):
                return Dataset.from_numpy(block, parallelism)
            # Arrow layout: split into zero-copy table slices.
            acc = BlockAccessor(block)
            n = acc.num_rows()
            parallelism = max(1, min(parallelism, n or 1))
            bounds = np.linspace(0, n, parallelism + 1, dtype=np.int64)
            return Dataset([acc.slice(int(a), int(b))
                            for a, b in zip(bounds[:-1], bounds[1:])],
                           [], parallelism)
        blocks = [BlockAccessor.from_arrow(t) for t in tables]
        return Dataset(blocks, [], max(1, len(blocks)))

    @staticmethod
    def read_parquet(paths: Union[str, List[str]],
                     parallelism: int = 8) -> "Dataset":
        from .context import DataContext
        fmt = DataContext.get().block_format
        return _read_files(_glob_paths(paths),
                           functools.partial(_load_parquet, fmt),
                           parallelism)

    @staticmethod
    def read_binary_files(paths: Union[str, List[str]],
                          parallelism: int = 8) -> "Dataset":
        """One row per file: {'bytes', 'path'} (reference:
        _internal/datasource/binary_datasource.py)."""
        from .datasource import expand_paths, load_binary_block
        return _read_files(expand_paths(paths), load_binary_block,
                           parallelism)

    @staticmethod
    def read_images(paths: Union[str, List[str]], *,
                    size: Optional[tuple] = None,
                    mode: Optional[str] = None,
                    parallelism: int = 8) -> "Dataset":
        """Decode image files to {'image', 'path'} rows; ``size=(H, W)``
        resizes at decode, ``mode`` converts color space (reference:
        _internal/datasource/image_datasource.py)."""
        from .datasource import (IMAGE_EXTS, expand_paths,
                                 load_image_block)
        loader = functools.partial(load_image_block, size=size, mode=mode)
        return _read_files(expand_paths(paths, IMAGE_EXTS), loader,
                           parallelism)

    @staticmethod
    def read_tfrecord(paths: Union[str, List[str]], *,
                      verify_crc: bool = False,
                      parallelism: int = 8) -> "Dataset":
        """Parse tf.train.Example TFRecord shards into columnar blocks —
        self-contained framing + protobuf codec, no tensorflow
        (reference: _internal/datasource/tfrecords_datasource.py)."""
        from .datasource import expand_paths, load_tfrecord_block
        loader = functools.partial(load_tfrecord_block,
                                   verify_crc=verify_crc)
        return _read_files(
            expand_paths(paths, (".tfrecord", ".tfrecords")), loader,
            parallelism)

    @staticmethod
    def read_csv(paths: Union[str, List[str]],
                 parallelism: int = 8) -> "Dataset":
        from .context import DataContext
        fmt = DataContext.get().block_format
        return _read_files(_glob_paths(paths),
                           functools.partial(_load_csv, fmt), parallelism)

    @staticmethod
    def read_json(paths: Union[str, List[str]],
                  parallelism: int = 8) -> "Dataset":
        from .context import DataContext
        fmt = DataContext.get().block_format
        return _read_files(_glob_paths(paths),
                           functools.partial(_load_json, fmt), parallelism)

    # ------------------------------------------------------------------ #
    # transforms
    # ------------------------------------------------------------------ #

    def _with_stage(self, stage: Stage) -> "Dataset":
        return Dataset(self._source, self._stages + [stage],
                       self._parallelism)

    def map(self, fn: Callable[[Dict], Dict]) -> "Dataset":
        return self._with_stage(Stage(f"map({_fn_name(fn)})",
                                      functools.partial(_map_rows, fn)))

    def map_batches(self, fn: Callable[[Block], Block],
                    batch_format: str = "numpy", **_compat) -> "Dataset":
        """``batch_format`` controls what the UDF sees ("numpy" dict by
        default, "pyarrow" for Table-native UDFs on Arrow pipelines);
        the returned value becomes the output block as-is.  On the
        distributed path ``fn`` must be defined at the top level of a
        module (tasks import it by reference)."""
        return self._with_stage(Stage(
            f"map_batches({_fn_name(fn)})",
            functools.partial(_map_batch, fn, batch_format)))

    def flat_map(self, fn: Callable[[Dict], List[Dict]]) -> "Dataset":
        return self._with_stage(Stage(f"flat_map({_fn_name(fn)})",
                                      functools.partial(_flat_map_rows, fn)))

    def filter(self, fn: Callable[[Dict], bool]) -> "Dataset":
        return self._with_stage(Stage(f"filter({_fn_name(fn)})",
                                      functools.partial(_filter_rows, fn)))

    def add_column(self, name: str,
                   fn: Callable[[Block], np.ndarray]) -> "Dataset":
        return self._with_stage(Stage(f"add_column({name})",
                                      functools.partial(_add_column, name,
                                                        fn)))

    def select_columns(self, cols: List[str]) -> "Dataset":
        """reference: Dataset.select_columns."""
        cols = list(cols)
        return self._with_stage(Stage(
            f"select_columns({cols})",
            functools.partial(_select_columns, cols)))

    def drop_columns(self, cols: List[str]) -> "Dataset":
        """reference: Dataset.drop_columns."""
        return self._with_stage(Stage(
            f"drop_columns({cols})",
            functools.partial(_drop_columns, frozenset(cols))))

    def rename_columns(self, mapping: Dict[str, str]) -> "Dataset":
        """reference: Dataset.rename_columns (rejects renames that would
        collide with a surviving column — a silent overwrite loses data)."""
        return self._with_stage(Stage(
            "rename_columns", functools.partial(_rename_columns,
                                                dict(mapping))))

    def unique(self, column: str) -> List[Any]:
        """Distinct values of a column (reference: Dataset.unique)."""
        from . import executor
        seen: set = set()
        for b in executor.execute_streaming(
                self.select_columns([column])):
            blk = executor.fetch(b)
            if blk and len(blk.get(column, ())):
                seen.update(np.unique(blk[column]).tolist())
        return sorted(seen)

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        """Distributed sort: sample -> range partition -> per-block sort;
        global order is the block order (reference: Dataset.sort over
        planner/exchange/sort_task_spec.py)."""
        return self._with_stage(Stage(
            f"sort[{key}]", _identity,
            kind=f"sort:{key}:{int(descending)}"))

    def groupby(self, key: str) -> "GroupedDataset":
        """reference: Dataset.groupby -> GroupedData (grouped_data.py)."""
        return GroupedDataset(self, key)

    def limit(self, n: int) -> "Dataset":
        """First n rows; consumes the stream only as far as needed
        (reference: Dataset.limit)."""
        from . import executor
        out: List[Any] = []
        count = 0
        stream = executor.execute_streaming(self)
        try:
            for b in stream:
                blk = executor.fetch(b)
                r = BlockAccessor(blk).num_rows()
                if count + r >= n:
                    out.append(BlockAccessor(blk).slice(0, n - count))
                    count = n
                    break
                if r:
                    out.append(blk)
                    count += r
        finally:
            # The tasks still in flight finish on their own; their refs
            # go with the generator's frame, and their segments with them.
            stream.close()
        return Dataset(out, [], self._parallelism)

    def union(self, *others: "Dataset") -> "Dataset":
        """Concatenate datasets (reference: Dataset.union).  Operand plans
        execute independently; the union is over their output blocks."""
        sources = list(self.materialize()._source)
        for o in others:
            sources.extend(o.materialize()._source)
        return Dataset(sources, [], self._parallelism)

    # -- writes (reference: data write_api / datasource writers) ---------- #

    def _write(self, path: str, writer: Callable[[Block, str], None],
               ext: str) -> List[str]:
        from .. import _tasks
        from . import executor
        os.makedirs(path, exist_ok=True)
        write_remote = _tasks.RemoteFunction(_write_block) \
            if _tasks.is_initialized() else None
        outs = []
        for i, b in enumerate(executor.execute_streaming(self)):
            fname = os.path.join(path, f"part-{i:05d}.{ext}")
            if write_remote is not None:
                outs.append(write_remote.remote(writer, b, fname))
            else:
                _write_block(writer, executor.fetch(b), fname)
                outs.append(fname)
        if write_remote is not None:
            from .._actor import get
            outs = get(outs, timeout=executor.TASK_TIMEOUT_S)
        return outs

    def write_parquet(self, path: str) -> List[str]:
        return self._write(path, _parquet_writer, "parquet")

    def write_tfrecord(self, path: str) -> List[str]:
        from .datasource import write_tfrecord_block
        return self._write(path, write_tfrecord_block, "tfrecord")

    def write_csv(self, path: str) -> List[str]:
        return self._write(path, _csv_writer, "csv")

    def write_json(self, path: str) -> List[str]:
        return self._write(path, _json_writer, "json")

    def random_shuffle(self, seed: Optional[int] = None) -> "Dataset":
        return self._with_stage(Stage("random_shuffle", _identity,
                                      kind=f"shuffle:{seed}"))

    def repartition(self, num_blocks: int) -> "Dataset":
        return self._with_stage(Stage("repartition", _identity,
                                      kind=f"repartition:{num_blocks}"))

    # ------------------------------------------------------------------ #
    # consumption
    # ------------------------------------------------------------------ #

    def materialize(self) -> "Dataset":
        from .executor import execute
        blocks = execute(self)
        return Dataset(blocks, [], self._parallelism)

    def _blocks(self) -> List[Block]:
        from .executor import execute, fetch
        return [fetch(b) for b in execute(self)]

    def count(self) -> int:
        return sum(BlockAccessor(b).num_rows() for b in self._blocks())

    def take(self, n: int = 20) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        for b in self._blocks():
            for row in BlockAccessor(b).iter_rows():
                out.append(row)
                if len(out) >= n:
                    return out
        return out

    def take_all(self) -> List[Dict[str, Any]]:
        return self.take(1 << 62)

    def schema(self) -> Dict[str, str]:
        for b in self._blocks():
            if BlockAccessor(b).num_rows():
                return BlockAccessor(b).schema()
        return {}

    def to_pandas(self):
        return BlockAccessor(
            BlockAccessor.concat(self._blocks())).to_pandas()

    def to_arrow_refs(self) -> List[Any]:
        """Execute the plan and return ObjectRefs of pyarrow Tables —
        the zero-copy hand-off to Arrow-native host pipelines (reference:
        Dataset.to_arrow_refs).  Without a session, the tables
        themselves."""
        from .. import _tasks
        from .._actor import ObjectRef, put
        from . import executor

        if not _tasks.is_initialized():
            # Driver-local fallback, like every other consumption path.
            return [_to_table(b) for b in executor.execute_streaming(self)]
        conv = _tasks.RemoteFunction(_to_table)
        out = []
        for b in executor.execute_streaming(self):
            if isinstance(b, ObjectRef) or executor._is_read_marker(b):
                out.append(conv.remote(b))
            else:
                out.append(put(BlockAccessor(b).to_arrow()))
        return out

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        for b in self._blocks():
            yield from BlockAccessor(b).iter_rows()

    def iter_batches(self, *, batch_size: int = 256,
                     drop_last: bool = False,
                     shuffle_seed: Optional[int] = None,
                     batch_format: str = "numpy") -> Iterator[Block]:
        """``batch_format``: "numpy" (dict of ndarrays, the device-feed
        format), "pyarrow" (Tables), or "pandas" (DataFrames) —
        reference: iter_batches batch_format."""
        from .iterator import iter_batches
        it = iter_batches(self, batch_size=batch_size,
                          drop_last=drop_last, shuffle_seed=shuffle_seed)
        if batch_format == "numpy":
            # Arrow pipelines materialize numpy HERE — the consumer
            # boundary — and nowhere earlier.
            return (BlockAccessor(b).to_numpy() for b in it)
        if batch_format == "pyarrow":
            return (BlockAccessor(b).to_arrow() for b in it)
        if batch_format == "pandas":
            return (BlockAccessor(b).to_pandas() for b in it)
        raise ValueError(f"unknown batch_format {batch_format!r}")

    def split(self, n: int) -> List["Dataset"]:
        """Split into n datasets by row count (for per-worker shards;
        reference: Dataset.split / streaming_split)."""
        blocks = self._blocks()
        full = BlockAccessor.concat(blocks)
        total = BlockAccessor(full).num_rows()
        bounds = np.linspace(0, total, n + 1, dtype=np.int64)
        out = []
        for a, b in zip(bounds[:-1], bounds[1:]):
            out.append(Dataset([BlockAccessor(full).slice(int(a), int(b))],
                               [], 1))
        return out

    def num_blocks(self) -> int:
        return len(self._source)

    def stats(self) -> str:
        return (f"Dataset(blocks={len(self._source)}, "
                f"stages={[s.name for s in self._stages]})")

    def __repr__(self):
        return self.stats()


def _read_files(paths: List[str], loader: Callable[[str], Block],
                parallelism: int) -> "Dataset":
    # One read task per file; the loader runs remotely at execution.
    blocks: List[Any] = [("__read__", loader, p) for p in paths]
    return Dataset(blocks, [], parallelism)


def range(n: int, parallelism: int = 8) -> Dataset:  # noqa: A001
    return Dataset.range(n, parallelism)


def from_items(items, parallelism: int = 8) -> Dataset:
    return Dataset.from_items(items, parallelism)


def from_numpy(arrays, parallelism: int = 8) -> Dataset:
    return Dataset.from_numpy(arrays, parallelism)


def from_pandas(df, parallelism: int = 8) -> Dataset:
    return Dataset.from_pandas(df, parallelism)


def from_arrow(tables, parallelism: int = 8) -> Dataset:
    return Dataset.from_arrow(tables, parallelism)


def read_parquet(paths, parallelism: int = 8) -> Dataset:
    return Dataset.read_parquet(paths, parallelism)


def read_binary_files(paths, parallelism: int = 8, **kw) -> Dataset:
    return Dataset.read_binary_files(paths, parallelism=parallelism, **kw)


def read_images(paths, parallelism: int = 8, **kw) -> Dataset:
    return Dataset.read_images(paths, parallelism=parallelism, **kw)


def read_tfrecord(paths, parallelism: int = 8, **kw) -> Dataset:
    return Dataset.read_tfrecord(paths, parallelism=parallelism, **kw)


def read_csv(paths, parallelism: int = 8) -> Dataset:
    return Dataset.read_csv(paths, parallelism)


def read_json(paths, parallelism: int = 8) -> Dataset:
    return Dataset.read_json(paths, parallelism)


# --------------------------------------------------------------------- #
# grouped datasets (reference: python/ray/data/grouped_data.py)
# --------------------------------------------------------------------- #

_AGG_OPS = ("count", "sum", "mean", "min", "max", "std")


def _agg_block(key: str, aggs: Dict[str, tuple], block: Block) -> Block:
    """Per-reduce-block aggregation: after the hash exchange every key
    lives wholly in one block, so local aggregates are global."""
    if block is None or BlockAccessor(block).num_rows() == 0:
        return {}
    block = BlockAccessor(block).to_numpy()
    uniq, inv = np.unique(block[key], return_inverse=True)
    out: Block = {key: uniq}
    for name, (col, op) in aggs.items():
        if op == "count":
            out[name] = np.bincount(inv, minlength=len(uniq))
            continue
        vals = np.asarray(block[col], np.float64)
        sums = np.bincount(inv, weights=vals, minlength=len(uniq))
        counts = np.bincount(inv, minlength=len(uniq))
        if op == "sum":
            out[name] = sums
        elif op == "mean":
            out[name] = sums / np.maximum(counts, 1)
        elif op == "std":
            sq = np.bincount(inv, weights=vals * vals, minlength=len(uniq))
            mean = sums / np.maximum(counts, 1)
            var = sq / np.maximum(counts, 1) - mean * mean
            out[name] = np.sqrt(np.maximum(var, 0.0))
        elif op == "min":
            acc = np.full(len(uniq), np.inf)
            np.minimum.at(acc, inv, vals)
            out[name] = acc
        elif op == "max":
            acc = np.full(len(uniq), -np.inf)
            np.maximum.at(acc, inv, vals)
            out[name] = acc
        else:
            raise ValueError(f"unknown aggregate op {op!r}")
    return out


def _map_groups_block(key: str, fn: Callable[[Block], Block],
                      block: Block) -> Block:
    if block is None or BlockAccessor(block).num_rows() == 0:
        return {}
    block = BlockAccessor(block).to_numpy()
    uniq, inv = np.unique(block[key], return_inverse=True)
    acc = BlockAccessor(block)
    pieces = []
    for g in _builtins.range(len(uniq)):
        sub = acc.take(np.nonzero(inv == g)[0])
        res = fn(sub)
        if res and BlockAccessor(res).num_rows():
            pieces.append(res)
    return BlockAccessor.concat(pieces) if pieces else {}


class GroupedDataset:
    """reference: GroupedData — aggregate/map_groups over a key."""

    def __init__(self, ds: Dataset, key: str):
        self._ds = ds
        self._key = key

    def _exchanged(self) -> Dataset:
        return self._ds._with_stage(Stage(
            f"groupby[{self._key}]", _identity,
            kind=f"groupshuffle:{self._key}"))

    def aggregate(self, **aggs: tuple) -> Dataset:
        """``aggregate(total=("value", "sum"), n=("value", "count"))`` —
        one output row per key, sorted by key within each block."""
        for name, (col, op) in aggs.items():
            if op not in _AGG_OPS:
                raise ValueError(
                    f"{name}: unknown op {op!r}; one of {_AGG_OPS}")
        return self._exchanged()._with_stage(Stage(
            "aggregate", functools.partial(_agg_block, self._key,
                                           dict(aggs))))

    def count(self) -> Dataset:
        return self.aggregate(count=(self._key, "count"))

    def sum(self, col: str) -> Dataset:
        return self.aggregate(**{f"sum({col})": (col, "sum")})

    def mean(self, col: str) -> Dataset:
        return self.aggregate(**{f"mean({col})": (col, "mean")})

    def min(self, col: str) -> Dataset:
        return self.aggregate(**{f"min({col})": (col, "min")})

    def max(self, col: str) -> Dataset:
        return self.aggregate(**{f"max({col})": (col, "max")})

    def std(self, col: str) -> Dataset:
        return self.aggregate(**{f"std({col})": (col, "std")})

    def map_groups(self, fn: Callable[[Block], Block]) -> Dataset:
        """Apply ``fn`` to each key's sub-block (reference:
        GroupedData.map_groups)."""
        return self._exchanged()._with_stage(Stage(
            "map_groups", functools.partial(_map_groups_block, self._key,
                                            fn)))


# --------------------------------------------------------------------- #
# block writers (used by Dataset.write_*)
# --------------------------------------------------------------------- #

def _write_block(writer, block_or_ref, path: str) -> str:
    from . import executor
    writer(executor.fetch(block_or_ref), path)
    return path


def _parquet_writer(block: Block, path: str) -> None:
    import pyarrow.parquet as pq
    pq.write_table(BlockAccessor(block).to_arrow(), path)


def _csv_writer(block: Block, path: str) -> None:
    BlockAccessor(block).to_pandas().to_csv(path, index=False)


def _json_writer(block: Block, path: str) -> None:
    BlockAccessor(block).to_pandas().to_json(path, orient="records",
                                             lines=True)
