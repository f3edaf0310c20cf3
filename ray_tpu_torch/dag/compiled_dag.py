"""CompiledDAG: static plan + per-actor execution loops over shm channels
(counterpart of ray_tpu/dag/compiled_dag.py over the port's actors).

Reference: python/ray/dag/compiled_dag_node.py:804 (CompiledDAG — compile
the bound DAG into ExecutableTasks per actor, allocate channels per edge,
run a resident loop on each actor, drive I/O from the driver) and
:2545 (execute).

Differences from per-call actor RPC: the graph is planned once — argument
routing, channel allocation, intra-actor locality — and each ``execute``
only moves payload bytes through single-writer/single-reader channels.
Capacity-1 channels give pipelined backpressure: stage k can work on
iteration i+1 while stage k+1 still holds iteration i.

The loop runs on each actor through ``ActorHandle.__ray_call__``, as an
ordinary call: it holds one of the actor's call threads until
``teardown``.  With ``max_concurrency=1`` every other call to that actor
queues behind it until then; after ``teardown`` the loop returns and the
actor serves calls again.

Payloads are pickled (protocol 5, numpy buffers out of band, the wire
format of JAX's ``pack_payload``) with the standard library's ``pickle``:
classes and functions go by reference, as an actor call's arguments do.
A CUDA tensor in a payload crosses a channel BY VALUE THROUGH THE HOST, as
an actor call carries it: torch's own pickling copies it to host bytes,
and the reader rebuilds it on its ``cuda`` card (the actor's current
device).  Nothing is shared on the card.  To hand off device memory
without the copy, send an ``_object_store`` descriptor
(``llm.disagg.export_handoff``), whose pickling shares each CUDA tensor as
an IPC handle; its sender settles the shares (``settle_sends``) as with an
actor call.
"""

from __future__ import annotations

import pickle
import struct
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

from .._actor import TaskError, get
from .channel import FLAG_DATA, FLAG_ERR, FLAG_STOP, ShmChannel

_HEADER = struct.Struct("<IQ")
_LEN = struct.Struct("<Q")


def pack_payload(obj: Any) -> bytes:
    """``[u32 n_buffers][u64 len_meta][meta]([u64 len][bytes])*``: the
    pickle with its out-of-band buffers after it."""
    buffers: List[pickle.PickleBuffer] = []
    meta = pickle.dumps(obj, protocol=5, buffer_callback=buffers.append)
    raws = [b.raw() for b in buffers]
    parts = [_HEADER.pack(len(raws), len(meta)), meta]
    for r in raws:
        parts += [_LEN.pack(r.nbytes), r]
    return b"".join(parts)


def unpack_payload(data: bytes) -> Any:
    src = memoryview(data)
    n_buffers, len_meta = _HEADER.unpack_from(src, 0)
    off = _HEADER.size
    meta = bytes(src[off: off + len_meta])
    off += len_meta
    bufs = []
    for _ in range(n_buffers):
        (n,) = _LEN.unpack_from(src, off)
        off += _LEN.size
        bufs.append(src[off: off + n])
        off += n
    return pickle.loads(meta, buffers=bufs)


def _error_payload(exc: BaseException, what: str) -> bytes:
    """A TaskError for ``exc``, packed (its cause as a repr where the
    exception itself does not pickle)."""
    tb = traceback.format_exc()
    try:
        return pack_payload(TaskError(exc, what, tb))
    except Exception:  # noqa: BLE001 - the cause itself won't pickle
        return pack_payload(TaskError(RuntimeError(repr(exc)), what, tb))


EdgeKey = Tuple[int, int]  # (producer node idx, consumer node idx; -1=driver)


def _dag_actor_loop(instance, plan: Dict[str, Any]) -> int:
    """Resident loop executed on the actor's worker via __ray_call__.

    Each iteration: for each of this actor's steps in topo order, read that
    step's input edges immediately before executing it, then write results
    to out-channels.  Per-step (not up-front) reads matter: a DAG that
    revisits an actor after passing through another (a.f -> b.g -> a.h)
    would deadlock if the loop blocked on the b->a channel before running
    f to feed b.  Errors are propagated as FLAG_ERR payloads instead of
    crashing the pipeline; STOP propagates downstream and ends the loop.
    """
    steps = plan["steps"]
    in_channels: Dict[EdgeKey, ShmChannel] = plan["in_channels"]
    out_channels: Dict[EdgeKey, ShmChannel] = plan["out_channels"]
    # Each in-channel feeds exactly one consumer step (edge keys embed the
    # consumer node idx); dedupe so a channel used in two arg positions of
    # the same step is read once per iteration.
    for step in steps:
        reads: List[EdgeKey] = []
        for kind, payload in list(step["args"]) + list(step["kwargs"].values()):
            if kind == "chan" and payload not in reads:
                reads.append(payload)
        step["reads"] = reads
    iterations = 0
    try:
        while True:
            chan_vals: Dict[EdgeKey, Any] = {}
            chan_errs: Dict[EdgeKey, bytes] = {}
            stop = False
            local_vals: Dict[int, Any] = {}
            local_errs: Dict[int, bytes] = {}
            for step in steps:
                for key in step["reads"]:
                    flag, payload = in_channels[key].read()
                    if flag == FLAG_STOP:
                        stop = True
                    elif flag == FLAG_ERR:
                        chan_errs[key] = payload
                    else:
                        chan_vals[key] = unpack_payload(payload)
                if stop:
                    break
                node_idx = step["node_idx"]
                if step.get("kind") == "collective":
                    # Broadcast this rank's contribution, read peers',
                    # reduce locally (all writes precede all reads, so
                    # capacity-1 channels cannot deadlock).
                    from .collective import _tree_reduce
                    _, contrib_idx = step["input"]
                    c_err = local_errs.get(contrib_idx)
                    if c_err is not None:
                        for key in step["peer_writes"]:
                            out_channels[key].write(c_err, FLAG_ERR)
                    else:
                        c_payload = pack_payload(
                            local_vals[contrib_idx])
                        for key in step["peer_writes"]:
                            out_channels[key].write(c_payload, FLAG_DATA)
                    values = [] if c_err is not None else \
                        [local_vals[contrib_idx]]
                    coll_err = c_err
                    for key in step["peer_reads"]:
                        flag, payload = in_channels[key].read()
                        if flag == FLAG_STOP:
                            stop = True
                        elif flag == FLAG_ERR:
                            coll_err = coll_err or payload
                        else:
                            values.append(
                                unpack_payload(payload))
                    if stop:
                        break
                    if coll_err is not None:
                        local_errs[node_idx] = coll_err
                        for key in step["writes"]:
                            out_channels[key].write(coll_err, FLAG_ERR)
                    else:
                        try:
                            reduced = _tree_reduce(step["op"], values)
                            local_vals[node_idx] = reduced
                            payload = pack_payload(reduced)
                            for key in step["writes"]:
                                out_channels[key].write(payload, FLAG_DATA)
                        except BaseException as exc:  # noqa: BLE001
                            e_payload = _error_payload(
                                exc, f"allreduce[{step['op']}]")
                            local_errs[node_idx] = e_payload
                            for key in step["writes"]:
                                out_channels[key].write(e_payload, FLAG_ERR)
                    continue
                err: Optional[bytes] = None
                args: List[Any] = []
                kwargs: Dict[str, Any] = {}

                def resolve(spec):
                    nonlocal err
                    kind, payload = spec
                    if kind == "const":
                        return payload
                    if kind == "chan":
                        if payload in chan_errs:
                            err = err or chan_errs[payload]
                            return None
                        return chan_vals[payload]
                    # kind == "local"
                    if payload in local_errs:
                        err = err or local_errs[payload]
                        return None
                    return local_vals[payload]

                for spec in step["args"]:
                    args.append(resolve(spec))
                for k, spec in step["kwargs"].items():
                    kwargs[k] = resolve(spec)
                payload = None
                if err is None:
                    try:
                        method = getattr(instance, step["method"])
                        out = method(*args, **kwargs)
                        local_vals[node_idx] = out
                        if step["writes"]:
                            payload = pack_payload(out)
                    except BaseException as exc:  # noqa: BLE001 — forwarded
                        err = _error_payload(exc, step["method"])
                if err is not None:
                    local_errs[node_idx] = err
                    for key in step["writes"]:
                        out_channels[key].write(err, FLAG_ERR)
                else:
                    for key in step["writes"]:
                        out_channels[key].write(payload, FLAG_DATA)
            if stop:
                # Teardown drains all executes before sending STOP, so the
                # first read of a fresh iteration is the only place STOP
                # appears — no step has written this iteration yet.
                for chan in out_channels.values():
                    chan.write(b"", FLAG_STOP)
                return iterations
            iterations += 1
    finally:
        for chan in list(in_channels.values()) + list(out_channels.values()):
            chan.close()


class CompiledDAGRef:
    """Future for one compiled execution (reference: CompiledDAGRef)."""

    def __init__(self, dag: "CompiledDAG", index: int):
        self._dag = dag
        self._index = index
        self._value: Any = None
        self._fetched = False

    def get(self, timeout: Optional[float] = None):
        if not self._fetched:
            self._value = self._dag._fetch(self._index, timeout)
            self._fetched = True
        if isinstance(self._value, Exception):
            raise self._value
        return self._value


class CompiledDAG:
    def __init__(self, output_node, *, buffer_size_bytes: int = 1 << 20,
                 submit_timeout: float = 30.0):
        from . import (ClassMethodNode, InputAttributeNode, InputNode,
                       MultiOutputNode)
        from .collective import CollectiveOutputNode
        self._buffer = buffer_size_bytes
        self._submit_timeout = submit_timeout
        self._lock = threading.Lock()
        self._torn_down = False
        self._next_execute = 0
        self._next_fetch = 0
        self._fetched: Dict[int, Any] = {}

        # ---- topo order over reachable nodes --------------------------- #
        order: List[Any] = []
        seen: Dict[int, int] = {}
        on_path: set = set()

        def visit(node):
            nid = id(node)
            if nid in seen:
                return
            if nid in on_path:
                raise ValueError("cycle detected in DAG")
            on_path.add(nid)
            for up in node._upstream():
                visit(up)
            on_path.discard(nid)
            seen[nid] = len(order)
            order.append(node)

        visit(output_node)
        idx_of = {id(n): i for i, n in enumerate(order)}

        terminals: List[Any]
        if isinstance(output_node, MultiOutputNode):
            terminals = output_node._outputs
        else:
            terminals = [output_node]
        if len({id(t) for t in terminals}) != len(terminals):
            raise ValueError("duplicate node in MultiOutputNode outputs")
        for t in terminals:
            if not isinstance(t, (ClassMethodNode, CollectiveOutputNode)):
                raise ValueError(
                    "compiled DAG outputs must be actor method calls or "
                    f"collective outputs, got {type(t).__name__}")
        compute_nodes = [n for n in order
                         if isinstance(n, (ClassMethodNode,
                                           CollectiveOutputNode))]
        if not any(isinstance(n, ClassMethodNode) for n in compute_nodes):
            raise ValueError("DAG contains no actor method calls")
        # Every output of a collective group must be part of this DAG:
        # the peer broadcast needs all ranks resident (reference:
        # collective_node.py binds all participants together).
        for n in compute_nodes:
            if isinstance(n, CollectiveOutputNode):
                for out in n._group.outputs:
                    if id(out) not in idx_of:
                        raise ValueError(
                            "all outputs of a collective group must be "
                            "consumed by (or be outputs of) the same "
                            "compiled DAG")
        for n in order:
            if isinstance(n, MultiOutputNode) and n is not output_node:
                raise ValueError("MultiOutputNode must be the DAG output")

        # Every compute node must (transitively) depend on the input so each
        # actor loop is triggered exactly once per execute.
        reaches_input: Dict[int, bool] = {}

        def check_reach(node) -> bool:
            nid = id(node)
            if nid in reaches_input:
                return reaches_input[nid]
            if isinstance(node, (InputNode, InputAttributeNode)):
                reaches_input[nid] = True
                return True
            r = any(check_reach(u) for u in node._upstream())
            reaches_input[nid] = r
            return r

        for n in compute_nodes:
            if not check_reach(n):
                raise ValueError(
                    f"{n!r} does not depend on the InputNode; every compiled "
                    "task needs a per-iteration trigger")

        # ---- plan edges ------------------------------------------------- #
        # (prod_idx, cons_idx) -> ShmChannel for cross-process edges.
        self._channels: Dict[EdgeKey, ShmChannel] = {}
        # input-producing nodes the driver must feed per edge.
        self._input_edges: List[Tuple[EdgeKey, Any]] = []  # (key, node)
        actor_of = {}  # node idx -> actor handle (by actor_id)
        for n in compute_nodes:
            actor_of[idx_of[id(n)]] = n._actor

        plans: Dict[str, Dict[str, Any]] = {}  # actor id -> plan

        def plan_for(actor) -> Dict[str, Any]:
            key = actor._actor_id
            if key not in plans:
                plans[key] = {"actor": actor, "steps": [],
                              "in_channels": {}, "out_channels": {}}
            return plans[key]

        def make_channel(ekey: EdgeKey) -> ShmChannel:
            if ekey not in self._channels:
                self._channels[ekey] = ShmChannel(self._buffer)
            return self._channels[ekey]

        planned_groups: set = set()
        self._peer_keys: set = set()  # collective peer edges; not consumer
        for n in compute_nodes:
            cons_idx = idx_of[id(n)]
            plan = plan_for(n._actor)
            if isinstance(n, CollectiveOutputNode):
                # Peer-to-peer broadcast + local reduce (one step per rank;
                # reference: collective_node.py lowering to NCCL allreduce,
                # here to pairwise shm channels).
                group = n._group
                gid = id(group)
                out_idx = {r: idx_of[id(group.outputs[r])]
                           for r in range(len(group.outputs))}
                if gid not in planned_groups:
                    planned_groups.add(gid)
                    for i in range(len(group.outputs)):
                        for j in range(len(group.outputs)):
                            if i != j:
                                pkey = (out_idx[i], out_idx[j])
                                make_channel(pkey)
                                self._peer_keys.add(pkey)
                rank = n._rank
                contrib = group.inputs[rank]
                peer_writes = []
                peer_reads = []
                for j in range(len(group.outputs)):
                    if j == rank:
                        continue
                    wkey = (out_idx[rank], out_idx[j])
                    rkey = (out_idx[j], out_idx[rank])
                    plan["out_channels"][wkey] = self._channels[wkey]
                    plan["in_channels"][rkey] = self._channels[rkey]
                    peer_writes.append(wkey)
                    peer_reads.append(rkey)
                plan["steps"].append({
                    "kind": "collective", "node_idx": cons_idx,
                    "op": group.op,
                    "input": ("local", idx_of[id(contrib)]),
                    "peer_writes": peer_writes, "peer_reads": peer_reads,
                    "args": [], "kwargs": {}, "writes": [],
                })
                continue
            arg_specs: List[Tuple[str, Any]] = []
            kwarg_specs: Dict[str, Tuple[str, Any]] = {}

            def spec_for(a):
                from . import DAGNode as _DN
                if not isinstance(a, _DN):
                    return ("const", a)
                prod_idx = idx_of[id(a)]
                if isinstance(a, (InputNode, InputAttributeNode)):
                    ekey = (prod_idx, cons_idx)
                    chan = make_channel(ekey)
                    plan["in_channels"][ekey] = chan
                    if all(k != ekey for k, _ in self._input_edges):
                        self._input_edges.append((ekey, a))
                    return ("chan", ekey)
                # producer is a ClassMethodNode
                prod_actor = actor_of[prod_idx]
                if prod_actor._actor_id == n._actor._actor_id:
                    return ("local", prod_idx)
                ekey = (prod_idx, cons_idx)
                chan = make_channel(ekey)
                plan["in_channels"][ekey] = chan
                plan_for(prod_actor)["out_channels"][ekey] = chan
                return ("chan", ekey)

            for a in n._args:
                arg_specs.append(spec_for(a))
            for k, a in n._kwargs.items():
                kwarg_specs[k] = spec_for(a)
            plan["steps"].append({
                "node_idx": cons_idx, "method": n._method,
                "args": arg_specs, "kwargs": kwarg_specs, "writes": [],
            })

        # Producer "writes" lists: fill after all edges are known.  Peer
        # channels are excluded: the collective step writes CONTRIBUTIONS
        # into them itself — treating them as consumer edges would push
        # the reduced value in as well, leaving a stale payload that
        # deadlocks the next iteration's contribution write.
        for ekey in self._channels:
            if ekey in self._peer_keys:
                continue
            prod_idx, cons_idx = ekey
            if prod_idx in actor_of:  # produced by an actor step
                plan = plan_for(actor_of[prod_idx])
                for step in plan["steps"]:
                    if step["node_idx"] == prod_idx and ekey not in step["writes"]:
                        step["writes"].append(ekey)

        # Output edges: terminal -> driver.
        self._output_keys: List[EdgeKey] = []
        for t in terminals:
            t_idx = idx_of[id(t)]
            ekey = (t_idx, -1)
            chan = make_channel(ekey)
            plan = plan_for(t._actor)
            plan["out_channels"][ekey] = chan
            for step in plan["steps"]:
                if step["node_idx"] == t_idx and ekey not in step["writes"]:
                    step["writes"].append(ekey)
            self._output_keys.append(ekey)
        self._multi_output = isinstance(output_node, MultiOutputNode)

        # Steps already appended in topo order (compute_nodes follows
        # `order`). Launch the loops.
        self._loop_refs = []
        for plan in plans.values():
            actor = plan.pop("actor")
            self._loop_refs.append(
                actor.__ray_call__.remote(_dag_actor_loop, plan))

    # ------------------------------------------------------------------ #

    def execute(self, *args, **kwargs) -> CompiledDAGRef:
        from . import InputNode
        with self._lock:
            if self._torn_down:
                raise RuntimeError("compiled DAG has been torn down")
            payloads = []
            for ekey, node in self._input_edges:
                if isinstance(node, InputNode):
                    value = node._eval_impl(None, args, kwargs)
                else:
                    value = InputNode.extract(node._key, args, kwargs)
                payloads.append((ekey, pack_payload(value)))
            # All-or-nothing submission: wait until EVERY input channel is
            # writable before writing ANY, so a saturated pipeline fails
            # without leaving some channels holding this iteration's value
            # and others not (which would silently pair inputs from
            # different execute() calls after a retry).  Writability is
            # monotonic here — the driver under this lock is the only
            # writer — so the post-check writes cannot block.
            deadline = time.monotonic() + self._submit_timeout
            try:
                for ekey, _ in payloads:
                    self._channels[ekey].wait_writable(
                        max(0.0, deadline - time.monotonic()))
            except TimeoutError as e:
                raise RuntimeError(
                    "compiled DAG pipeline is full — call .get() on "
                    "earlier CompiledDAGRefs before submitting more "
                    "executions") from e
            for ekey, payload in payloads:
                self._channels[ekey].write(payload, FLAG_DATA)
            index = self._next_execute
            self._next_execute += 1
        return CompiledDAGRef(self, index)

    def _fetch(self, index: int, timeout: Optional[float]) -> Any:
        with self._lock:
            if index in self._fetched:
                return self._fetched.pop(index)
            if self._torn_down and self._next_fetch > index:
                raise RuntimeError(
                    "compiled DAG was torn down before this result was "
                    "fetched")
            while self._next_fetch <= index:
                self._advance(timeout)
            return self._fetched.pop(index)

    def _check_loops_alive(self) -> None:
        """Surface actor-loop death instead of spinning forever."""
        done = [r for r in self._loop_refs if r.future().done()]
        if done and not self._torn_down:
            try:
                get(done)
            except Exception as e:
                raise RuntimeError(
                    f"a compiled DAG actor loop died: {e!r}") from e
            raise RuntimeError(
                "a compiled DAG actor loop exited unexpectedly")

    def _advance(self, timeout: Optional[float]) -> None:
        """Read one full iteration's outputs into ``_fetched``.

        Partially-read outputs are staged in ``_partial`` so a timeout
        midway never desyncs the channels: a retry resumes with the
        channels that were not yet read.  The timeout is a shared deadline
        across all outputs, with liveness checks between bounded waits.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        if not hasattr(self, "_partial"):
            self._partial = {}
        while len(self._partial) < len(self._output_keys):
            pos = len(self._partial)
            ekey = self._output_keys[pos]
            if deadline is None:
                slice_timeout = 1.0
            else:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"timed out fetching compiled DAG output {pos}")
                slice_timeout = min(1.0, remaining)
            try:
                flag, payload = self._channels[ekey].read(slice_timeout)
            except TimeoutError:
                self._check_loops_alive()
                continue
            self._partial[pos] = (flag, payload)
        results = []
        error: Optional[Exception] = None
        for pos in range(len(self._output_keys)):
            flag, payload = self._partial[pos]
            if flag == FLAG_ERR:
                error = error or unpack_payload(payload)
                results.append(None)
            elif flag == FLAG_STOP:
                error = error or RuntimeError("DAG torn down")
                results.append(None)
            else:
                results.append(unpack_payload(payload))
        self._partial = {}
        value: Any = error if error is not None else (
            results if self._multi_output else results[0])
        self._fetched[self._next_fetch] = value
        self._next_fetch += 1

    def teardown(self) -> None:
        with self._lock:
            if self._torn_down:
                return
            self._torn_down = True
            # Drain unfetched results so STOP can flow through capacity-1
            # channels without blocking on stale payloads.  Drained values
            # stay in _fetched so later ref.get() calls still succeed.
            try:
                while self._next_fetch < self._next_execute:
                    self._advance(timeout=5.0)
            except Exception:
                pass
            for ekey, _node in self._input_edges:
                try:
                    self._channels[ekey].write(b"", FLAG_STOP, timeout=5.0)
                except Exception:
                    pass
        try:
            get(self._loop_refs, timeout=10.0)
        except Exception:  # noqa: BLE001 - a dead loop has nothing to stop
            pass
        for chan in self._channels.values():
            chan.close()
            chan.unlink()

    def __del__(self):
        try:
            if not self._torn_down:
                self.teardown()
        except Exception:
            pass
