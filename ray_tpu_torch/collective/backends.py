"""Collective backends (counterpart of ``ray_tpu/collective/backends.py``):
a ``torch.distributed`` process group (gloo over host arrays, NCCL over
the cards; JAX's ``XlaBackend``) and the pure-Python ``KVBackend``.

Rendezvous runs through this process's ``_control.py`` store.  Rank 0
publishes a fresh incarnation nonce at ``collective/<group>/meta``, so a
group re-made under the same name never reads an earlier incarnation's
keys; the members then meet under ``collective/<group>/<nonce>``.  Each
group opens its own client of the store: a member blocked in a
rendezvous (``TCPStore.wait``) holds that client's socket, not the one the
rest of its process shares.

``send``/``recv`` go through the group: the process group's own
point-to-point ops, or keys of the store for ``KVBackend`` (JAX runs both
over a socket of its own, ``_SocketP2P``).
"""

from __future__ import annotations

import datetime
import pickle
import time

import numpy as np

_RENDEZVOUS_TIMEOUT_S = 120.0
#: Longest single ``TCPStore.wait``: a lost reply cannot strand the caller
#: past its deadline.
_WAIT_CHUNK_S = 10.0
_OPS = ("sum", "prod", "min", "max")


def _own_store():
    """A new client of this process's store (the main process's session
    store, or the one an actor was started with)."""
    from .._control import ControlPlane, current
    try:
        plane = current()
    except RuntimeError:
        from .. import _actor
        plane = _actor._plane()
    return ControlPlane.connect(plane.host, plane.port)


def _wait_for(plane, key: str,
              timeout: float = _RENDEZVOUS_TIMEOUT_S) -> bytes:
    """Block until ``key`` exists (the store's own wait, in chunks), and
    return its value."""
    deadline = time.monotonic() + timeout
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise TimeoutError(f"rendezvous timed out waiting for {key}")
        try:
            plane.store.wait([key], datetime.timedelta(
                seconds=min(remaining, _WAIT_CHUNK_S)))
        except RuntimeError:     # the chunk ran out (DistStoreError)
            continue
        v = plane.kv_get(key)
        if v is not None:
            return v


def _nonce(plane, group_name: str, rank: int) -> str:
    meta_key = f"collective/{group_name}/meta"
    if rank == 0:
        import uuid
        nonce = uuid.uuid4().hex[:8]
        plane.kv_put(meta_key, nonce.encode())
        return nonce
    return _wait_for(plane, meta_key).decode()


class DistBackend:
    """Group ops over a ``torch.distributed`` process group built directly
    on ``PrefixStore(f"collective/{group}/{nonce}", store)`` (no default
    group, so several groups live in one process): gloo for host arrays,
    NCCL for CUDA tensors on this process's current card.  Inputs may be
    numpy arrays or tensors; results are numpy arrays, as JAX's are."""

    def __init__(self, world_size: int, rank: int, group_name: str,
                 backend: str = "gloo"):
        if backend not in ("gloo", "nccl"):
            raise ValueError(f"unknown torch.distributed backend "
                             f"{backend!r}")
        self.world_size = world_size
        self.rank = rank
        self.group_name = group_name
        self.backend = backend
        self._plane = None
        self._pg = None

    def setup(self) -> None:
        import torch
        import torch.distributed as dist
        self._plane = _own_store()
        nonce = _nonce(self._plane, self.group_name, self.rank)
        store = dist.PrefixStore(f"collective/{self.group_name}/{nonce}",
                                 self._plane.store)
        timeout = datetime.timedelta(seconds=_RENDEZVOUS_TIMEOUT_S)
        if self.backend == "gloo":
            self._pg = dist.ProcessGroupGloo(store, self.rank,
                                             self.world_size, timeout)
            self._device = torch.device("cpu")
        else:
            if not torch.cuda.is_available():
                raise RuntimeError("the NCCL collective backend needs a "
                                   "card; use backend='gloo'")
            opts = dist.ProcessGroupNCCL.Options()
            opts._timeout = timeout
            self._pg = dist.ProcessGroupNCCL(store, self.rank,
                                             self.world_size, opts)
            self._device = torch.device("cuda", torch.cuda.current_device())
        # Every member has joined once the first op completes.
        self.barrier()

    def teardown(self) -> None:
        pg, self._pg = self._pg, None
        if pg is not None and hasattr(pg, "shutdown"):
            try:
                pg.shutdown()
            except RuntimeError:
                pass
        if self.rank == 0 and self._plane is not None:
            self._plane.kv_del(f"collective/{self.group_name}/meta")

    # -- helpers ------------------------------------------------------------

    def _tensor(self, x):
        import torch
        if isinstance(x, torch.Tensor):
            t = x.detach()
        else:
            t = torch.from_numpy(np.array(x, copy=True))
        return t.to(self._device).contiguous()

    @staticmethod
    def _numpy(t) -> np.ndarray:
        return t.cpu().numpy()

    @staticmethod
    def _reduce_op(op: str):
        import torch.distributed as dist
        if op not in _OPS:
            raise ValueError(f"unknown reduce op {op!r}")
        return {"sum": dist.ReduceOp.SUM, "prod": dist.ReduceOp.PRODUCT,
                "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}[op]

    # -- ops ----------------------------------------------------------------

    def allreduce(self, tensor, op: str = "sum"):
        import torch.distributed as dist
        t = self._tensor(tensor)
        opts = dist.AllreduceOptions()
        opts.reduceOp = self._reduce_op(op)
        self._pg.allreduce([t], opts).wait()
        return self._numpy(t)

    def allgather(self, tensor):
        """[world, *shape]: every member's array, in rank order."""
        import torch
        t = self._tensor(tensor)
        parts = [torch.empty_like(t) for _ in range(self.world_size)]
        self._pg.allgather([parts], [t]).wait()
        return self._numpy(torch.stack(parts))

    def reducescatter(self, tensor, op: str = "sum"):
        """Input per rank: [world * chunk, ...]; returns this rank's chunk
        of the reduction."""
        full = self.allreduce(tensor, op)
        n = full.shape[0]
        if n % self.world_size:
            raise ValueError(
                f"reducescatter dim {n} not divisible by {self.world_size}")
        chunk = n // self.world_size
        return full[self.rank * chunk:(self.rank + 1) * chunk]

    def broadcast(self, tensor, src_rank: int = 0):
        import torch.distributed as dist
        t = self._tensor(tensor)
        opts = dist.BroadcastOptions()
        opts.rootRank = src_rank
        opts.rootTensor = 0
        self._pg.broadcast([t], opts).wait()
        return self._numpy(t)

    def reduce(self, tensor, dst_rank: int = 0, op: str = "sum"):
        out = self.allreduce(tensor, op)
        return out if self.rank == dst_rank else np.asarray(tensor)

    def barrier(self) -> None:
        self.allreduce(np.zeros(1, np.float32), "sum")

    def send(self, tensor, dst_rank: int) -> None:
        self._pg.send([self._tensor(tensor)], dst_rank, 0).wait()

    def recv(self, shape, dtype, src_rank: int):
        import torch
        buf = torch.from_numpy(np.empty(shape, dtype)).to(self._device)
        self._pg.recv([buf], src_rank, 0).wait()
        return self._numpy(buf)


class KVBackend:
    """Pure-Python collective over the store (a copy of JAX's
    ``KVBackend``): correct for any picklable numpy payload.  Each op round
    gets a sequence number so groups can run many ops."""

    def __init__(self, world_size: int, rank: int, group_name: str):
        self.world_size = world_size
        self.rank = rank
        self.group_name = group_name
        self._seq = 0
        self._nonce = ""
        self._plane = None
        self._sent: dict = {}
        self._received: dict = {}

    def _base(self) -> str:
        return f"collective/{self.group_name}/{self._nonce}"

    def setup(self) -> None:
        self._plane = _own_store()
        self._nonce = _nonce(self._plane, self.group_name, self.rank)
        base = self._base()
        self._plane.kv_put(f"{base}/join/{self.rank}", b"1")
        deadline = time.monotonic() + _RENDEZVOUS_TIMEOUT_S
        for r in range(self.world_size):
            _wait_for(self._plane, f"{base}/join/{r}",
                      deadline - time.monotonic())

    def teardown(self) -> None:
        base = self._base()
        self._plane.kv_del(f"{base}/join/{self.rank}")
        for s in (self._seq, self._seq - 1):
            if s > 0:
                self._plane.kv_del(f"{base}/r{s}/{self.rank}")
        if self.rank == 0:
            self._plane.kv_del(f"collective/{self.group_name}/meta")

    def _round(self, tensor) -> list:
        """Exchange: everyone publishes, everyone reads all.

        Garbage collection: entering round n proves every rank finished
        round n-1 (we read all its keys), which proves every rank had
        finished reading round n-2 — so each rank deletes its own n-2 key
        here, bounding the store's growth to two rounds.
        """
        self._seq += 1
        base = self._base()
        if self._seq >= 3:
            self._plane.kv_del(f"{base}/r{self._seq - 2}/{self.rank}")
        self._plane.kv_put(f"{base}/r{self._seq}/{self.rank}",
                           pickle.dumps(np.asarray(tensor)))
        return [pickle.loads(_wait_for(self._plane,
                                       f"{base}/r{self._seq}/{r}"))
                for r in range(self.world_size)]

    @staticmethod
    def _reduce(parts: list, op: str):
        fns = {"sum": np.add, "prod": np.multiply, "min": np.minimum,
               "max": np.maximum}
        out = parts[0].copy()
        for p in parts[1:]:
            out = fns[op](out, p)
        return out

    def allreduce(self, tensor, op: str = "sum"):
        return self._reduce(self._round(tensor), op)

    def allgather(self, tensor):
        return np.stack(self._round(tensor))

    def reducescatter(self, tensor, op: str = "sum"):
        full = self.allreduce(tensor, op)
        if full.shape[0] % self.world_size:
            raise ValueError(
                f"reducescatter dim {full.shape[0]} not divisible by "
                f"{self.world_size}")
        chunk = full.shape[0] // self.world_size
        return full[self.rank * chunk:(self.rank + 1) * chunk]

    def broadcast(self, tensor, src_rank: int = 0):
        return self._round(tensor)[src_rank]

    def reduce(self, tensor, dst_rank: int = 0, op: str = "sum"):
        out = self.allreduce(tensor, op)
        return out if self.rank == dst_rank else np.asarray(tensor)

    def barrier(self) -> None:
        self._round(np.zeros(1))

    def send(self, tensor, dst_rank: int) -> None:
        """One key per message, numbered per (source, destination); the
        receiver deletes it."""
        n = self._sent.get(dst_rank, 0)
        self._sent[dst_rank] = n + 1
        self._plane.kv_put(f"{self._base()}/p2p/{self.rank}-{dst_rank}/{n}",
                           pickle.dumps(np.asarray(tensor)))

    def recv(self, shape, dtype, src_rank: int):
        n = self._received.get(src_rank, 0)
        self._received[src_rank] = n + 1
        key = f"{self._base()}/p2p/{src_rank}-{self.rank}/{n}"
        out = pickle.loads(_wait_for(self._plane, key))
        self._plane.kv_del(key)
        return out
