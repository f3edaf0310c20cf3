"""Framework-internal lint rules (RT2xx): invariants of ray_tpu_torch itself
(a copy of ray_tpu/devtools/rules_internal.py).

These run only on files inside the ``ray_tpu_torch`` package tree (the
self-lint gate in tests/test_torch_devtools.py keeps the tree clean), and
on snippets linted with ``internal=True``.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterator, List, Optional, Set, Tuple

from .lint import (Finding, ModuleContext, Rule, dotted, register,
                   walk_same_scope)

#: A with-target whose dotted name's last segment matches this is
#: treated as a mutex for RT201.
_LOCKISH_RE = re.compile(r"(lock|cond|mutex|cv)", re.IGNORECASE)

#: Modules where a swallowed exception hides scheduler/runtime state
#: corruption (RT202).  Matched as a suffix of the normalized path.
CONTROL_PLANE_MODULES = (
    "ray_tpu_torch/_scheduler.py",
    "ray_tpu_torch/_tasks.py",
    "ray_tpu_torch/_actor.py",
)

#: Attribute calls that block the calling thread (RT201).
_BLOCKING_ATTRS = {"recv", "recv_bytes", "accept", "communicate",
                   "check_call", "check_output", "result"}
_BLOCKING_DOTTED = {"time.sleep", "select.select", "subprocess.run",
                    "subprocess.call", "subprocess.check_call",
                    "subprocess.check_output"}


def _condition_locks(ctx: ModuleContext) -> Dict[str, str]:
    """``cond name -> lock name`` for ``X = threading.Condition(Y)``
    assignments: waiting on X while holding Y is the *correct* condition
    idiom (wait releases Y), so RT201 must not flag it."""
    out: Dict[str, str] = {}
    for node in ctx.nodes(ast.Assign):
        v = node.value
        if isinstance(v, ast.Call) and \
                (dotted(v.func) or "").endswith("Condition") and v.args:
            lock = dotted(v.args[0])
            if lock:
                for t in node.targets:
                    name = dotted(t)
                    if name:
                        out[name] = lock
    return out


def _is_str_join(call: ast.Call) -> bool:
    """Distinguish ``sep.join(iterable)`` from ``thread.join(timeout)``:
    flag only zero-arg joins, numeric-literal timeouts, or a ``timeout=``
    keyword — the unambiguous thread/process forms."""
    if any(kw.arg == "timeout" for kw in call.keywords):
        return False
    if not call.args and not call.keywords:
        return False
    if len(call.args) == 1 and isinstance(call.args[0], ast.Constant) and \
            isinstance(call.args[0].value, (int, float)):
        return False
    return True


@register
class BlockingUnderLock(Rule):
    id = "RT201"
    example_bad = (
        "with self._lock:\n"
        "    time.sleep(1.0)     # every contender convoys\n")
    example_good = (
        "with self._lock:\n"
        "    work = self._take()\n"
        "time.sleep(1.0)         # block after releasing\n")
    scope = "internal"
    summary = "blocking call while holding a lock"
    rationale = ("A sleep/join/recv/wait/subprocess call under a held "
                 "lock stalls every thread contending for it — the "
                 "classic control-plane convoy; release the lock before "
                 "blocking, or use a Condition on that lock.")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        cond_locks = _condition_locks(ctx)
        for node in ctx.nodes(ast.With, ast.AsyncWith):
            lock_names: Set[str] = set()
            for item in node.items:
                name = dotted(item.context_expr)
                if name and _LOCKISH_RE.search(name.split(".")[-1]):
                    lock_names.add(name)
            if not lock_names:
                continue
            for sub in walk_same_scope(node):
                if not isinstance(sub, ast.Call):
                    continue
                label = self._blocking_label(sub, lock_names, cond_locks)
                if label:
                    held = ", ".join(sorted(lock_names))
                    # Suppressible at the call line or the with line (a
                    # lock that intentionally serializes slow work gets
                    # one noqa on the with statement).
                    yield ctx.finding(
                        self, sub,
                        f"{label} while holding {held}: blocking under a "
                        f"lock convoys every contending thread",
                        anchors=(node,))

    def _blocking_label(self, call: ast.Call, lock_names: Set[str],
                        cond_locks: Dict[str, str]) -> Optional[str]:
        name = dotted(call.func)
        if name in _BLOCKING_DOTTED:
            return f"{name}()"
        if not isinstance(call.func, ast.Attribute):
            return None
        attr = call.func.attr
        recv = dotted(call.func.value)
        if attr in ("wait", "wait_for"):
            # Waiting on the condition guarding this very lock is the
            # idiom (wait releases the lock); waiting on anything else
            # (an Event, another lock's condition) blocks while held.
            if recv in lock_names:
                return None
            if recv and cond_locks.get(recv) in lock_names:
                return None
            return f"{recv or attr}.{attr}()" if recv else f"{attr}()"
        if attr == "join":
            if _is_str_join(call):
                return None
            return f"{recv or '<expr>'}.join()"
        if attr in _BLOCKING_ATTRS:
            return f"{recv or '<expr>'}.{attr}()"
        return None


@register
class SwallowedException(Rule):
    id = "RT202"
    example_bad = (
        "try:\n"
        "    handler(msg)\n"
        "except Exception:\n"
        "    pass                 # state corruption hides\n")
    example_good = (
        "try:\n"
        "    handler(msg)\n"
        "except Exception as e:\n"
        "    telemetry.note_swallowed(\"runtime.handler\", e)\n")
    scope = "internal"
    summary = "bare `except Exception: pass` in a control-plane module"
    rationale = ("A silently swallowed control-plane error hides state "
                 "corruption until an unrelated hang; log it or bump "
                 "ray_tpu_internal_swallowed_errors_total "
                 "(telemetry.note_swallowed).")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if not ctx.module_key.endswith(CONTROL_PLANE_MODULES):
            return
        for node in ctx.nodes(ast.Try):
            for handler in node.handlers:
                t = handler.type
                broad = t is None or (
                    isinstance(t, ast.Name) and
                    t.id in ("Exception", "BaseException"))
                if not broad:
                    continue
                body = [s for s in handler.body
                        if not (isinstance(s, ast.Expr) and
                                isinstance(s.value, ast.Constant))]
                if all(isinstance(s, (ast.Pass, ast.Continue))
                       for s in body):
                    yield ctx.finding(
                        self, handler,
                        "swallowed exception in a control-plane module: "
                        "log it or call telemetry.note_swallowed(where)")


@register
class WallClockDuration(Rule):
    id = "RT203"
    example_bad = (
        "t0 = time.time()\n"
        "work()\n"
        "elapsed = time.time() - t0   # NTP step corrupts it\n")
    example_good = (
        "t0 = time.monotonic()\n"
        "work()\n"
        "elapsed = time.monotonic() - t0\n")
    scope = "internal"
    summary = "duration arithmetic on time.time()"
    rationale = ("Wall clocks step under NTP; intervals, deadlines and "
                 "timeouts must come from time.monotonic().  time.time() "
                 "stays correct for timestamps that are only recorded.")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if "time.time" not in ctx.source:
            return  # the rule is about literal time.time() call sites
        scopes: List[ast.AST] = [ctx.tree]
        scopes += ctx.nodes(ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)
        for scope in scopes:
            tainted = self._tainted_names(scope)
            for node in walk_same_scope(scope):
                if isinstance(node, ast.BinOp) and \
                        isinstance(node.op, ast.Sub):
                    if self._is_wall(node.left, tainted) or \
                            self._is_wall(node.right, tainted):
                        yield ctx.finding(
                            self, node,
                            "interval computed from time.time(): use "
                            "time.monotonic() (NTP steps corrupt "
                            "wall-clock arithmetic)")
                elif isinstance(node, ast.Compare):
                    ops_ok = all(isinstance(op, (ast.Lt, ast.LtE, ast.Gt,
                                                 ast.GtE))
                                 for op in node.ops)
                    sides = [node.left] + list(node.comparators)
                    if ops_ok and any(self._is_wall(s, tainted)
                                      for s in sides):
                        yield ctx.finding(
                            self, node,
                            "deadline comparison on time.time(): use "
                            "time.monotonic()")

    @staticmethod
    def _tainted_names(scope: ast.AST) -> Set[str]:
        out: Set[str] = set()
        for node in walk_same_scope(scope):
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call) and \
                    dotted(node.value.func) == "time.time":
                out |= {t.id for t in node.targets
                        if isinstance(t, ast.Name)}
        return out

    @staticmethod
    def _is_wall(node: ast.AST, tainted: Set[str]) -> bool:
        if isinstance(node, ast.Call) and dotted(node.func) == "time.time":
            return True
        return isinstance(node, ast.Name) and node.id in tainted


@register
class UnknownTelemetrySeries(Rule):
    id = "RT204"
    example_bad = (
        "telemetry.inc(\"ray_tpu_misspelled_total\")  # silently records nothing\n")
    example_good = (
        "# declare the series in util/telemetry.py CATALOG first\n"
        "telemetry.inc(\"ray_tpu_serve_requests_total\")\n")
    scope = "internal"
    summary = "telemetry series name missing from the catalog"
    rationale = ("util/telemetry.py's CATALOG is the single source of "
                 "truth for built-in series; a name minted at a call "
                 "site silently records nothing (inc/observe/set_gauge "
                 "swallow the KeyError).")

    _FNS = {"inc", "observe", "set_gauge", "counter", "gauge", "histogram"}

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if "telemetry" not in ctx.source:
            return  # any alias/import spells the word somewhere
        try:
            from ray_tpu_torch.util.telemetry import CATALOG
        except Exception:  # not importable from this checkout: skip
            return
        aliases, direct = self._telemetry_names(ctx)
        if not aliases and not direct:
            return
        for node in ctx.nodes(ast.Call):
            if not node.args:
                continue
            fn = None
            if isinstance(node.func, ast.Attribute) and \
                    isinstance(node.func.value, ast.Name) and \
                    node.func.value.id in aliases and \
                    node.func.attr in self._FNS:
                fn = node.func.attr
            elif isinstance(node.func, ast.Name) and \
                    node.func.id in direct:
                fn = direct[node.func.id]
            if fn is None:
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and \
                    isinstance(arg.value, str) and \
                    arg.value not in CATALOG:
                yield ctx.finding(
                    self, node,
                    f"telemetry.{fn}({arg.value!r}): not in the "
                    f"util/telemetry.py CATALOG — declare it there or "
                    f"fix the name")

    @staticmethod
    def _telemetry_names(ctx: ModuleContext):
        aliases: Set[str] = set()
        direct: Dict[str, str] = {}
        for node in ctx.nodes(ast.Import, ast.ImportFrom):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name.endswith("telemetry"):
                        aliases.add(a.asname or a.name.split(".")[-1])
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                if mod.endswith("util") or mod.endswith("ray_tpu_torch.util"):
                    for a in node.names:
                        if a.name == "telemetry":
                            aliases.add(a.asname or "telemetry")
                elif mod.endswith("telemetry"):
                    for a in node.names:
                        if a.name in UnknownTelemetrySeries._FNS:
                            direct[a.asname or a.name] = a.name
        return aliases, direct


#: Modules whose on-disk files other processes treat as commit records
#: (RT206): a torn write here IS state corruption, so every publication
#: must be tmp-file + os.replace.  Matched against the normalized path.
_ATOMIC_PUBLISH_MODULES = (
    "/checkpoint/",            # the distributed checkpointing subsystem
    "train/_checkpoint.py",    # its compat shim
    "_private/persist.py",     # head-state WAL/snapshot store
)


@register
class NonAtomicPublish(Rule):
    id = "RT206"
    example_bad = (
        "with open(manifest_path, \"w\") as f:   # torn prefix on crash\n"
        "    json.dump(doc, f)\n")
    example_good = (
        "write_bytes_atomic(manifest_path,\n"
        "                   json.dumps(doc).encode())  # tmp + os.replace\n")
    scope = "internal"
    summary = "non-atomic file publication in a checkpoint/control-plane " \
              "module"
    rationale = ("A manifest/index written with a bare open(path, 'w') can "
                 "be observed (or survive a crash) as a torn prefix that "
                 "parses as a valid-looking file; publish through a tmp "
                 "file + os.replace (checkpoint.format.write_bytes_atomic) "
                 "so the path either holds the full bytes or nothing.")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        key = ctx.module_key
        if not (any(key.endswith(m) for m in _ATOMIC_PUBLISH_MODULES
                    if not m.startswith("/"))
                or any(m in key for m in _ATOMIC_PUBLISH_MODULES
                       if m.startswith("/"))):
            return
        for node in ctx.nodes(ast.Call):
            if dotted(node.func) not in ("open", "io.open") or \
                    not node.args:
                continue
            mode = node.args[1] if len(node.args) >= 2 else next(
                (kw.value for kw in node.keywords if kw.arg == "mode"),
                None)
            if not (isinstance(mode, ast.Constant) and
                    isinstance(mode.value, str) and
                    mode.value.startswith("w")):
                continue
            # The tmp+replace idiom names its staging path: a path
            # expression mentioning "tmp" (tmp var, .tmp suffix,
            # mkstemp/mkdtemp product) is the atomic pattern's first
            # half, not a publication.
            path_src = ast.unparse(node.args[0])
            if "tmp" in path_src.lower():
                continue
            yield ctx.finding(
                self, node,
                f"open({path_src}, {mode.value!r}) publishes a file "
                f"non-atomically: write to a tmp path and os.replace() "
                f"into place (see checkpoint.format.write_bytes_atomic)")


def _module_uses_jax(ctx: ModuleContext) -> bool:
    """Does this module import jax / jax.numpy / jax.random (at module or
    function level), or hold the lazy ``self._jax`` module handle?  (The
    gate of ray_tpu/devtools/rules_jax.py's ``module_uses_jax``.)"""
    for node in ctx.nodes(ast.Import):
        if any(a.name == "jax" or a.name.startswith("jax.")
               for a in node.names):
            return True
    for node in ctx.nodes(ast.ImportFrom):
        if node.level == 0 and node.module and (
                node.module == "jax" or node.module.startswith("jax.")):
            return True
    return any(isinstance(n, ast.Attribute) and n.attr == "_jax" and
               isinstance(n.value, ast.Name) and n.value.id == "self"
               for n in ctx.nodes(ast.Attribute))


@register
class DevicePutAliasedHostBuffer(Rule):
    id = "RT207"
    example_bad = (
        "buf = np.zeros((8, 128))\n"
        "x = jax.device_put(buf, sharding)\n"
        "buf[0] = 1.0   # mutates the device value it aliases\n")
    example_good = (
        "buf = np.zeros((8, 128))\n"
        "x = jax.device_put(buf.copy(), sharding)\n"
        "buf[0] = 1.0   # device copy is independent\n")
    scope = "internal"
    summary = "jax.device_put of a host buffer mutated in the same scope"
    rationale = ("On CPU (and zero-copy shm-store views) jax.device_put "
                 "may alias the host ndarray instead of copying; an "
                 "in-place write to that buffer after dispatch silently "
                 "corrupts the device value (the mesh/pipeline dispatch "
                 "aliasing hazard).  Pass a real copy (.copy()) — NOT "
                 "np.ascontiguousarray, which returns the SAME object "
                 "for an already-contiguous buffer — or stop mutating "
                 "the buffer.")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if "device_put" not in ctx.source:
            return
        # Scope: a module that imports jax (the port itself never does;
        # the rule keeps the JAX package's meaning for linted user code).
        # Its eager-torch counterpart, a host buffer read by a copy
        # that may not have run, is the RT5xx family's (rules_torch).
        if not _module_uses_jax(ctx):
            return
        scopes: List[ast.AST] = [ctx.tree]
        scopes += ctx.nodes(ast.FunctionDef, ast.AsyncFunctionDef)
        for scope in scopes:
            mutated = self._mutated_lines(scope)
            if not mutated:
                continue
            for node in walk_same_scope(scope):
                if not (isinstance(node, ast.Call) and
                        (dotted(node.func) or "").endswith("device_put")
                        and node.args):
                    continue
                arg = node.args[0]
                # Only mutations AFTER the dispatch can corrupt the
                # device value; fill-then-dispatch is the normal safe
                # init pattern.  (Line order approximates execution
                # order: a loop that mutates textually above a dispatch
                # inside it is not caught — keep dispatches out of
                # mutate-loops anyway.)
                if isinstance(arg, ast.Name) and any(
                        line > node.lineno
                        for line in mutated.get(arg.id, ())):
                    yield ctx.finding(
                        self, node,
                        f"jax.device_put({arg.id!r}) of a host buffer "
                        f"mutated after dispatch: device_put may alias "
                        f"instead of copy — dispatch a real copy "
                        f"({arg.id}.copy(); ascontiguousarray does NOT "
                        f"copy contiguous buffers)")

    @staticmethod
    def _mutated_lines(scope: ast.AST) -> Dict[str, List[int]]:
        """Line numbers of in-place writes per name: subscript-store
        targets (``buf[i] = ...``) and augmented assignments
        (``buf += ...`` / ``buf[i] += ...``).  Rebinding (``buf = ...``)
        is NOT mutation — the old buffer the device aliased is
        unchanged."""
        out: Dict[str, List[int]] = {}
        for node in walk_same_scope(scope):
            targets: List[ast.AST] = []
            if isinstance(node, ast.Assign):
                targets = list(node.targets)
            elif isinstance(node, ast.AugAssign):
                targets = [node.target]
            for t in targets:
                name = None
                if isinstance(t, ast.Subscript):
                    name = dotted(t.value)
                elif isinstance(node, ast.AugAssign) and \
                        isinstance(t, ast.Name):
                    name = t.id
                if name:
                    out.setdefault(name, []).append(node.lineno)
        return out


@register
class ProtocolHandlerMissing(Rule):
    id = "RT205"
    example_bad = (
        "@dataclass\n"
        "class NewMessage:      # declared in protocol.py...\n"
        "    x: int = 0\n"
        "# ...but no isinstance(msg, NewMessage) handler anywhere\n")
    example_good = (
        "# in worker.py/node.py/runtime.py/cluster.py:\n"
        "if isinstance(msg, NewMessage):\n"
        "    handle_new_message(msg)\n")
    scope = "internal"
    summary = "protocol message type with no registered handler"
    rationale = ("Every dataclass in _private/protocol.py must be "
                 "dispatched via isinstance() in worker.py / node.py / "
                 "runtime.py / cluster.py; an unhandled type is either "
                 "dead wire surface or a message that silently drops.")

    #: Payload structs carried inside other messages, not dispatched.
    EXEMPT = {"TaskSpec"}
    HANDLER_MODULES = ("worker.py", "node.py", "runtime.py", "cluster.py")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if not ctx.module_key.endswith("_private/protocol.py"):
            return
        declared: Dict[str, ast.ClassDef] = {
            node.name: node for node in ctx.tree.body
            if isinstance(node, ast.ClassDef) and
            node.name not in self.EXEMPT}
        handled = self.handled_names(os.path.dirname(ctx.path))
        if handled is None:
            return  # snippet with no sibling handler files: skip
        for name, node in declared.items():
            if name not in handled:
                yield ctx.finding(
                    self, node,
                    f"protocol message {name} has no isinstance() "
                    f"handler in {'/'.join(self.HANDLER_MODULES)}: wire "
                    f"it up or delete the message type")

    @classmethod
    def handled_names(cls, private_dir: str) -> Optional[Set[str]]:
        """Class names appearing as an isinstance() classinfo in any
        handler module (shared with tests/test_protocol_coverage.py)."""
        out: Set[str] = set()
        found_any = False
        for fname in cls.HANDLER_MODULES:
            path = os.path.join(private_dir, fname)
            if not os.path.exists(path):
                continue
            found_any = True
            with open(path, encoding="utf-8") as f:
                tree = ast.parse(f.read(), filename=path)
            for node in ast.walk(tree):
                if not (isinstance(node, ast.Call) and
                        isinstance(node.func, ast.Name) and
                        node.func.id == "isinstance" and
                        len(node.args) == 2):
                    continue
                info = node.args[1]
                names = info.elts if isinstance(info, ast.Tuple) else [info]
                out |= {n.id for n in names if isinstance(n, ast.Name)}
        return out if found_any else None
