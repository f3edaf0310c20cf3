"""Checkpoint wire format v1 (counterpart of ray_tpu/checkpoint/format.py):
sharded per-rank layout with an atomic manifest, byte-compatible with the
JAX package's both ways.

Layout of one checkpoint directory::

    shard-00000-of-00002.bin         per-rank data: concatenated raw leaf chunks
    shard-00000-of-00002.index.json  per-rank chunk index (leaf -> offsets/slices)
    skeleton.pkl                     tree structure with _LeafMarker leaves (rank 0)
    manifest.json                    global commit record (rank 0, atomic)

Commit protocol: every rank writes only its shard pair (each file lands via
tmp-file + ``os.replace``); rank 0 writes ``manifest.json``, also tmp +
``os.replace``, only after every rank's pair is complete.  A directory
without a valid manifest is not a checkpoint.  The manifest carries a
self-checksum plus per-shard byte sizes and crc32s; every chunk a restore
reads is checked against its own crc32, so torn or bit-rotted checkpoints
fail closed.

Leaves are named by their key paths ("params/blocks/wq"), as JAX names
them; each chunk records the slice of the *global* array it holds, so any
saved layout restores onto any other.  A DTensor contributes its rank's
block, written once over its replicas; a plain tensor is written whole.

Without ``ml_dtypes`` or numpy's help: dtypes travel as numpy's names
("bfloat16" included) and bytes as raw little-endian C-order data, read
back with ``torch.frombuffer``.  ``skeleton.pkl`` pickles the JAX package's
``_LeafMarker`` and, for an optimizer state, optax's ``ScaleByAdamState``
and ``EmptyState``: the port writes those names without importing either
package, and reads them with an unpickler that maps them to its own classes
(``_LeafMarker``, ``optim.AdamState``, ``optim.EmptyState``) and refuses any
other class that is not a plain builtin.

The legacy single-file layout (``save_pytree``/``load_pytree``: one
``pytree.pkl`` of numpy arrays, JAX's ``train.Checkpoint.from_pytree``) is
written and read for the dtypes numpy has; bf16 (JAX pickles it through
``ml_dtypes``) and orbax raise, naming ``save_checkpoint``.
"""

from __future__ import annotations

import builtins
import collections
import hashlib
import io
import json
import os
import pickle
import sys
import tempfile
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from .._tree import tree_flatten_with_keys, tree_map, tree_map_with_keys
from ..optim import AdamState, EmptyState
from . import sharding

FORMAT_NAME = "ray_tpu_ckpt_v1"
MANIFEST = "manifest.json"
SKELETON = "skeleton.pkl"


class CheckpointError(Exception):
    """A checkpoint failed to serialize, commit, validate, or restore."""


class _LeafMarker:
    """Placeholder leaf in the pickled structure skeleton."""

    def __repr__(self):
        return "<leaf>"


#: The port's classes in a skeleton, by the names the JAX package pickles.
_WIRE_NAMES = {
    _LeafMarker: ("ray_tpu.checkpoint.format", "_LeafMarker"),
    AdamState: ("optax._src.transform", "ScaleByAdamState"),
    EmptyState: ("optax._src.base", "EmptyState"),
}
_FROM_WIRE = {wire: cls for cls, wire in _WIRE_NAMES.items()}
_BUILTINS = frozenset((
    "int", "float", "complex", "bool", "str", "bytes", "bytearray", "tuple",
    "list", "dict", "set", "frozenset", "slice", "range"))

_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in _DTYPES.items()}


class _Pickler(pickle._Pickler):
    """Pickles the port's wire classes under the JAX package's names (the
    pure-Python pickler, whose ``save_global`` can be overridden)."""

    def save_global(self, obj, name=None):
        wire = _WIRE_NAMES.get(obj)
        if wire is None:
            return super().save_global(obj, name)
        self.save(wire[0])
        self.save(wire[1])
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        cls = _FROM_WIRE.get((module, name))
        if cls is not None:
            return cls
        if module == "builtins" and name in _BUILTINS:
            return getattr(builtins, name)
        if (module, name) == ("collections", "OrderedDict"):
            return collections.OrderedDict
        raise CheckpointError(f"checkpoint pickle names {module}.{name}, "
                              "which the port does not read")


def _dumps(obj: Any) -> bytes:
    buf = io.BytesIO()
    _Pickler(buf, protocol=5).dump(obj)
    return buf.getvalue()


def _loads(data: bytes) -> Any:
    return _Unpickler(io.BytesIO(data)).load()


@dataclass
class LeafChunk:
    """One rank-local piece of one leaf: ``array`` (a CPU tensor) covers
    ``index`` of the leaf's global shape."""
    index: Tuple[Tuple[int, int], ...]
    array: Any


@dataclass
class LeafSnapshot:
    dtype: str
    global_shape: Tuple[int, ...]
    chunks: List[LeafChunk] = field(default_factory=list)
    #: Non-array leaf: pickled payload instead of chunks.
    obj_payload: Optional[bytes] = None


@dataclass
class Snapshot:
    """Host-side copy of this rank's tree shards."""
    leaves: Dict[str, LeafSnapshot]
    skeleton_pkl: bytes
    nbytes: int


def _is_marker(x) -> bool:
    return isinstance(x, _LeafMarker)


def snapshot_tree(tree: Any,
                  shard_spec: Optional[Callable] = None) -> Snapshot:
    """Tensors -> host chunks (the blocking part of a save).

    ``shard_spec(key, leaf)`` may return ``(global_shape, index)`` to
    declare that this rank holds only ``index`` of a larger global array.
    A DTensor contributes its rank's block with its global index, and only
    from the replica at index 0 of every mesh dim it is replicated over, so
    each block is written once.  Plain tensors are written whole by every
    rank (restore keeps the lowest rank's copy)."""
    from ..parallel.sharding import dtensor_index, is_primary
    DTensor = _dtensor_class()
    skeleton = tree_map_with_keys(lambda _k, _x: _LeafMarker(), tree)
    leaves: Dict[str, LeafSnapshot] = {}
    nbytes = 0
    for key, leaf in tree_flatten_with_keys(tree):
        if not isinstance(leaf, torch.Tensor):
            leaves[key] = LeafSnapshot(dtype="object", global_shape=(),
                                       obj_payload=_dumps(leaf))
            nbytes += len(leaves[key].obj_payload)
            continue
        dtype = _DTYPE_NAMES.get(leaf.dtype)
        if dtype is None:
            raise CheckpointError(f"leaf {key!r}: dtype {leaf.dtype} has no "
                                  "checkpoint name")
        spec = shard_spec(key, leaf) if shard_spec is not None else None
        if spec is not None:
            global_shape, index = spec
            snap = LeafSnapshot(dtype, tuple(int(d) for d in global_shape))
            snap.chunks.append(LeafChunk(
                sharding.normalize_index(index, global_shape), _host(leaf)))
        elif isinstance(leaf, DTensor):
            snap = LeafSnapshot(dtype, tuple(leaf.shape))
            if is_primary(leaf):
                snap.chunks.append(LeafChunk(dtensor_index(leaf),
                                             _host(leaf.to_local())))
        else:
            snap = LeafSnapshot(dtype, tuple(leaf.shape))
            snap.chunks.append(LeafChunk(sharding.full_index(leaf.shape),
                                         _host(leaf)))
        leaves[key] = snap
        nbytes += sum(c.array.numel() * c.array.element_size()
                      for c in snap.chunks)
    return Snapshot(leaves=leaves, skeleton_pkl=_dumps(skeleton),
                    nbytes=nbytes)


def _dtensor_class():
    """``DTensor``, or ``()`` (no instance of anything) where no module has
    imported it yet: then no leaf can be one, and a save does not pay the
    import (about a second)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod.DTensor if mod is not None else ()


def _host(t: torch.Tensor) -> torch.Tensor:
    """A CPU copy of ``t`` that owns its bytes.  A CPU tensor is cloned:
    ``.to("cpu")`` would return the same storage, and the optimizer
    updates params, mu and nu in place, so an asynchronous write of an
    uncloned snapshot would write the next step's values.  A card tensor
    is copied to the host synchronously."""
    t = t.detach()
    if t.device.type == "cpu":
        return t.clone(memory_format=torch.contiguous_format)
    return t.to("cpu").contiguous()


def _raw(t: torch.Tensor) -> bytes:
    """A CPU tensor's bytes, C order (numpy's ``tobytes``)."""
    return t.reshape(-1).view(torch.uint8).numpy().tobytes()


# -- shard build/write ------------------------------------------------------


def shard_basename(rank: int, world: int) -> str:
    return f"shard-{rank:05d}-of-{world:05d}"


def build_shard(snapshot: Snapshot, rank: int, world: int,
                step: int) -> Tuple[Dict[str, Any], bytes]:
    """Serialize one rank's snapshot into (index dict, data blob)."""
    buf = io.BytesIO()
    index_leaves: Dict[str, Any] = {}
    for key, snap in snapshot.leaves.items():
        if snap.obj_payload is not None:
            off = buf.tell()
            buf.write(snap.obj_payload)
            index_leaves[key] = {
                "kind": "object", "offset": off,
                "nbytes": len(snap.obj_payload),
                "crc32": zlib.crc32(snap.obj_payload) & 0xFFFFFFFF}
            continue
        chunks = []
        for c in snap.chunks:
            off = buf.tell()
            raw = _raw(c.array)
            buf.write(raw)
            chunks.append({"offset": off, "nbytes": len(raw),
                           "crc32": zlib.crc32(raw) & 0xFFFFFFFF,
                           "index": [list(p) for p in c.index]})
        index_leaves[key] = {
            "kind": "array", "dtype": snap.dtype,
            "global_shape": list(snap.global_shape), "chunks": chunks}
    blob = buf.getvalue()
    index = {
        "format": FORMAT_NAME,
        "step": step,
        "rank": rank,
        "world_size": world,
        "data_file": shard_basename(rank, world) + ".bin",
        "nbytes": len(blob),
        "crc32": zlib.crc32(blob) & 0xFFFFFFFF,
        "leaves": index_leaves,
    }
    return index, blob


def write_bytes_atomic(path: str, data: bytes) -> None:
    """tmp-file + fsync + ``os.replace``: the path either holds the
    complete bytes or does not exist."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               prefix=os.path.basename(path) + ".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def write_shard(dirpath: str, index: Dict[str, Any], blob: bytes,
                skeleton_pkl: Optional[bytes] = None) -> None:
    """Publish one rank's shard pair (and, on rank 0, the skeleton)."""
    os.makedirs(dirpath, exist_ok=True)
    write_bytes_atomic(os.path.join(dirpath, index["data_file"]), blob)
    if skeleton_pkl is not None:
        write_bytes_atomic(os.path.join(dirpath, SKELETON), skeleton_pkl)
    base = shard_basename(index["rank"], index["world_size"])
    write_bytes_atomic(os.path.join(dirpath, base + ".index.json"),
                       json.dumps(index).encode())


# -- manifest ----------------------------------------------------------------


def manifest_checksum(manifest: Dict[str, Any]) -> str:
    body = {k: v for k, v in manifest.items() if k != "checksum"}
    return hashlib.sha256(
        json.dumps(body, sort_keys=True).encode()).hexdigest()


def build_manifest(dirpath: str, step: int, world: int,
                   metrics: Optional[Dict[str, Any]] = None,
                   replica: bool = False) -> Dict[str, Any]:
    """Assemble the global manifest from the per-rank shard indexes;
    raises CheckpointError when any rank's pair is missing or its data
    file does not match the index."""
    shards = []
    leaves: Dict[str, Any] = {}
    for rank in range(world):
        base = shard_basename(rank, world)
        ipath = os.path.join(dirpath, base + ".index.json")
        try:
            with open(ipath, "rb") as f:
                index = json.loads(f.read())
        except (OSError, ValueError) as e:
            raise CheckpointError(
                f"rank {rank} shard index missing/unreadable: {e}")
        dpath = os.path.join(dirpath, index["data_file"])
        try:
            size = os.path.getsize(dpath)
        except OSError:
            raise CheckpointError(f"rank {rank} data file missing: {dpath}")
        if size != index["nbytes"]:
            raise CheckpointError(
                f"rank {rank} data file is {size}B, index says "
                f"{index['nbytes']}B")
        shards.append({"rank": rank, "data_file": index["data_file"],
                       "index_file": base + ".index.json",
                       "nbytes": index["nbytes"], "crc32": index["crc32"]})
        for key, spec in index["leaves"].items():
            if spec["kind"] == "array" and key not in leaves:
                leaves[key] = {"dtype": spec["dtype"],
                               "global_shape": spec["global_shape"]}
    manifest = {
        "format": FORMAT_NAME,
        "step": step,
        "world_size": world,
        "time": time.time(),
        "replica": bool(replica),
        "metrics": dict(metrics or {}),
        "shards": shards,
        "leaves": leaves,
        "total_bytes": sum(s["nbytes"] for s in shards),
    }
    manifest["checksum"] = manifest_checksum(manifest)
    return manifest


def commit_manifest(dirpath: str, manifest: Dict[str, Any]) -> None:
    """The commit point: after this replace, the checkpoint exists."""
    write_bytes_atomic(os.path.join(dirpath, MANIFEST),
                       json.dumps(manifest, indent=1).encode())


def read_manifest(dirpath: str) -> Dict[str, Any]:
    with open(os.path.join(dirpath, MANIFEST), "rb") as f:
        manifest = json.loads(f.read())
    if manifest.get("checksum") != manifest_checksum(manifest):
        raise CheckpointError(f"manifest checksum mismatch in {dirpath}")
    return manifest


def is_committed(dirpath: str) -> bool:
    return os.path.exists(os.path.join(dirpath, MANIFEST))


def verify_checkpoint(dirpath: str, deep: bool = False) -> List[str]:
    """Validity problems for a checkpoint dir ([] = valid).  Shallow: the
    manifest parses, its self-checksum matches, every shard file exists
    with its size; ``deep`` also checks every data file's crc32."""
    problems: List[str] = []
    try:
        manifest = read_manifest(dirpath)
    except FileNotFoundError:
        return ["no manifest (uncommitted or not a checkpoint)"]
    except (CheckpointError, ValueError, OSError) as e:
        return [f"manifest invalid: {e}"]
    for sh in manifest["shards"]:
        dpath = os.path.join(dirpath, sh["data_file"])
        if not os.path.exists(dpath):
            problems.append(f"missing {sh['data_file']}")
            continue
        size = os.path.getsize(dpath)
        if size != sh["nbytes"]:
            problems.append(
                f"{sh['data_file']}: {size}B on disk, manifest says "
                f"{sh['nbytes']}B")
            continue
        if deep:
            with open(dpath, "rb") as f:
                crc = zlib.crc32(f.read()) & 0xFFFFFFFF
            if crc != sh["crc32"]:
                problems.append(f"{sh['data_file']}: crc32 mismatch")
    return problems


def save(dirpath: str, tree: Any, step: int = 0,
         metrics: Optional[Dict[str, Any]] = None) -> Snapshot:
    """Write ``tree`` as a committed checkpoint from every rank of the
    ``torch.distributed`` world (one rank when none is initialised): each
    rank its shard pair, then rank 0 the manifest.  Every rank must call
    it.  Returns this rank's snapshot."""
    import torch.distributed as dist
    multi = dist.is_initialized() and dist.get_world_size() > 1
    rank, world = (dist.get_rank(), dist.get_world_size()) if multi \
        else (0, 1)
    snap = snapshot_tree(tree)
    index, blob = build_shard(snap, rank, world, step)
    write_shard(dirpath, index, blob,
                skeleton_pkl=snap.skeleton_pkl if rank == 0 else None)
    if multi:
        dist.barrier()
    if rank == 0:
        commit_manifest(dirpath, build_manifest(dirpath, step, world,
                                                metrics=metrics))
    if multi:
        dist.barrier()
    return snap


# -- restore -----------------------------------------------------------------


class _FileShardSource:
    """Reads leaf chunks of one rank's shard straight off its data file:
    only the byte ranges a restore needs are read."""

    def __init__(self, dirpath: str, index: Dict[str, Any]):
        self.index = index
        self._path = os.path.join(dirpath, index["data_file"])

    def read(self, offset: int, nbytes: int) -> bytes:
        with open(self._path, "rb") as f:
            f.seek(offset)
            return f.read(nbytes)


def _load_skeleton(dirpath: str):
    with open(os.path.join(dirpath, SKELETON), "rb") as f:
        return _loads(f.read())


def _tensor(raw: bytes, dtype: torch.dtype, shape) -> torch.Tensor:
    if not raw:
        return torch.empty(shape, dtype=dtype)
    return torch.frombuffer(bytearray(raw), dtype=dtype).reshape(shape)


def _assemble(sources: List[Any], placement: Optional[Callable],
              skeleton: Any) -> Any:
    """Gather this rank's slices of every leaf from the shard sources.
    ``placement(key, global_shape) -> index`` names the slice wanted (None:
    the whole array)."""
    by_key: Dict[str, Tuple[Dict[str, Any], List[Tuple[Any, Dict]]]] = {}
    for src in sources:
        for key, spec in src.index["leaves"].items():
            entry = by_key.setdefault(key, (spec, []))
            if spec["kind"] == "array":
                for c in spec["chunks"]:
                    entry[1].append((src, c))
            else:
                entry[1].append((src, spec))

    def _checked_read(src, meta) -> bytes:
        raw = src.read(meta["offset"], meta["nbytes"])
        crc = meta.get("crc32")
        if len(raw) != meta["nbytes"] or (
                crc is not None and
                (zlib.crc32(raw) & 0xFFFFFFFF) != crc):
            raise CheckpointError(
                f"shard chunk at offset {meta['offset']} failed crc/size "
                f"verification (bit rot or torn write)")
        return raw

    def _restore_leaf(key: str, _marker):
        if key not in by_key:
            raise CheckpointError(f"leaf {key!r} absent from all shards")
        spec, stored = by_key[key]
        if spec["kind"] == "object":
            src, meta = stored[0]
            return _loads(_checked_read(src, meta))
        global_shape = tuple(spec["global_shape"])
        dtype = _DTYPES.get(spec["dtype"])
        if dtype is None:
            raise CheckpointError(f"leaf {key!r}: dtype {spec['dtype']!r} "
                                  "is not one the port reads")
        target = sharding.normalize_index(
            placement(key, global_shape) if placement is not None else None,
            global_shape)
        # Replicated leaves written by several ranks: the first copy.
        seen = set()
        chunks = []
        for src, c in stored:
            cidx = tuple(tuple(p) for p in c["index"])
            if cidx in seen:
                continue
            seen.add(cidx)
            chunks.append((src, c, cidx))
        for src, c, cidx in chunks:
            if cidx == target:
                return _tensor(_checked_read(src, c), dtype,
                               sharding.index_shape(target))
        out = torch.empty(sharding.index_shape(target), dtype=dtype)
        covered = torch.zeros(sharding.index_shape(target), dtype=torch.bool)
        for src, c, cidx in chunks:
            inter = sharding.intersect(cidx, target)
            if inter is None:
                continue
            arr = _tensor(_checked_read(src, c), dtype,
                          sharding.index_shape(cidx))
            sharding.copy_region(out, target, arr, cidx, inter)
            sharding.copy_region(covered, target, None, None, inter,
                                 fill=True)
        missing = covered.numel() - int(covered.sum())
        if missing:
            raise CheckpointError(
                f"leaf {key!r}: stored shards leave {missing} of "
                f"{covered.numel()} requested elements uncovered "
                f"(target {target})")
        return out

    return tree_map_with_keys(_restore_leaf, skeleton, is_leaf=_is_marker)


def restore_tree(dirpath: str, placement: Optional[Callable] = None) -> Any:
    """Restore a tree of CPU tensors from a committed checkpoint directory.
    ``placement(key, global_shape) -> index`` reshards on the fly (None =
    assemble whole arrays)."""
    manifest = read_manifest(dirpath)
    skeleton = _load_skeleton(dirpath)
    sources: List[Any] = []
    for sh in manifest["shards"]:
        with open(os.path.join(dirpath, sh["index_file"]), "rb") as f:
            sources.append(_FileShardSource(dirpath, json.loads(f.read())))
    return _assemble(sources, placement, skeleton)


# -- legacy single-file pickle layout ---------------------------------------

PYTREE_PKL = "pytree.pkl"
_NO_ORBAX = ("orbax checkpoints are not read or written by the port (orbax "
             "imports JAX); save with train.save_checkpoint, the sharded "
             "format both packages read")
#: The numpy names a numpy pickle refers to (numpy 1 and 2 spellings).
_NUMPY_GLOBALS = frozenset(
    (mod, name)
    for core in ("numpy.core", "numpy._core")
    for mod, name in ((f"{core}.multiarray", "_reconstruct"),
                      (f"{core}.multiarray", "scalar"),
                      (f"{core}.numeric", "_frombuffer"))
) | {("numpy", "ndarray"), ("numpy", "dtype")}


class _NumpyUnpickler(pickle.Unpickler):
    """Reads a ``pytree.pkl``: numpy arrays in builtin containers, nothing
    else."""

    def find_class(self, module, name):
        if module.split(".")[0] == "ml_dtypes":
            raise CheckpointError(
                f"pytree.pkl holds an ml_dtypes array ({name}): JAX pickles "
                "bfloat16 through ml_dtypes, which the port does not use; "
                "save bf16 trees with train.save_checkpoint (the sharded "
                "format keeps bf16 as raw bytes)")
        if (module, name) in _NUMPY_GLOBALS:
            import importlib
            return getattr(importlib.import_module(module), name)
        if module == "builtins" and name in _BUILTINS:
            return getattr(builtins, name)
        if (module, name) == ("collections", "OrderedDict"):
            return collections.OrderedDict
        raise CheckpointError(f"pytree.pkl names {module}.{name}, which the "
                              "port does not read")


def _numpy_leaf(x):
    import numpy as np
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            raise CheckpointError(
                "a bfloat16 leaf cannot go into pytree.pkl: numpy has no "
                "bfloat16 (JAX pickles it through ml_dtypes); save it with "
                "train.save_checkpoint")
        return x.detach().to("cpu").numpy().copy()
    return np.asarray(x)


def _tensor_leaf(x):
    import numpy as np
    if isinstance(x, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(x, copy=True))
    return x


def save_pytree(tree: Any, path: str, use_orbax: bool = False) -> None:
    """Legacy synchronous save: every leaf to host numpy, one pickle at
    ``path/pytree.pkl`` that the JAX package's ``load_pytree`` reads (numpy
    arrays; bf16 and orbax raise ``CheckpointError``)."""
    if use_orbax:
        raise CheckpointError(_NO_ORBAX)
    t0 = time.perf_counter()
    host = tree_map(_numpy_leaf, tree)
    write_bytes_atomic(os.path.join(path, PYTREE_PKL),
                       pickle.dumps(host, protocol=5))
    _note_legacy("save", time.perf_counter() - t0)


def load_pytree(path: str, use_orbax: bool = False) -> Any:
    """A committed sharded checkpoint through ``restore_tree``, else the
    legacy ``pytree.pkl`` with its numpy arrays as CPU tensors."""
    if use_orbax:
        raise CheckpointError(_NO_ORBAX)
    t0 = time.perf_counter()
    if is_committed(path):
        out = restore_tree(path)
    else:
        with open(os.path.join(path, PYTREE_PKL), "rb") as f:
            out = tree_map(_tensor_leaf, _NumpyUnpickler(f).load())
    _note_legacy("restore", time.perf_counter() - t0)
    return out


def _note_legacy(op: str, seconds: float) -> None:
    from ..util import telemetry
    telemetry.observe("ray_tpu_train_checkpoint_seconds", seconds,
                      tags={"op": op})
    telemetry.note_checkpoint_seconds(seconds)
    if op == "restore":
        telemetry.observe("ray_tpu_ckpt_restore_seconds", seconds,
                          tags={"source": "disk"})
