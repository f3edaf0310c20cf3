"""User-code lint rules (RT1xx): ``ray_tpu_torch`` usage anti-patterns (a
copy of ray_tpu/devtools/rules_user.py over the port's API names).

These encode the failure modes the docs warn about (reference: the Ray
anti-pattern catalog — ray.get in a loop, nested ray.get deadlocks,
large objects captured in closures) as static checks over the *shape*
of the call, so they fire in CI instead of in a postmortem.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from .lint import (Finding, ModuleContext, Rule, dotted, register,
                   walk_same_scope)

#: Constant elements at/above which a literal counts as "large" for
#: closure-capture purposes (RT103).
LARGE_LITERAL_ELEMS = 64

_UNSERIALIZABLE_CTORS = {
    "threading.Lock": "a threading.Lock",
    "threading.RLock": "a threading.RLock",
    "threading.Condition": "a threading.Condition",
    "threading.Semaphore": "a threading.Semaphore",
    "threading.Event": "a threading.Event",
    "open": "an open file handle",
    "socket.socket": "a socket",
}

_ARRAY_CTORS = {"zeros", "ones", "full", "empty", "arange", "array",
                "rand", "randn"}


def _remote_decorated(node) -> bool:
    """True for ``@remote`` / ``@ray_tpu_torch.remote`` / ``@ray.remote`` and
    their called forms (``@remote(num_tpus=1)``)."""
    for dec in node.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        name = dotted(target)
        if name and name.split(".")[-1] == "remote":
            return True
    return False


def _module_aliases(ctx: ModuleContext) -> Tuple[Set[str], Set[str]]:
    """(module aliases for ray_tpu_torch/ray, bare names bound to their
    get)."""
    mods: Set[str] = set()
    gets: Set[str] = set()
    for node in ctx.nodes(ast.Import, ast.ImportFrom):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name in ("ray_tpu_torch", "ray"):
                    mods.add(a.asname or a.name)
        elif isinstance(node, ast.ImportFrom):
            if node.module in ("ray_tpu_torch", "ray"):
                for a in node.names:
                    if a.name == "get":
                        gets.add(a.asname or "get")
    return mods, gets


def _is_framework_get(call: ast.Call, mods: Set[str],
                      gets: Set[str]) -> bool:
    func = call.func
    if isinstance(func, ast.Name):
        return func.id in gets
    if isinstance(func, ast.Attribute) and func.attr == "get":
        return isinstance(func.value, ast.Name) and func.value.id in mods
    return False


def _const_count(node: ast.AST, cap: int) -> int:
    n = 0
    for sub in ast.walk(node):
        if isinstance(sub, ast.Constant):
            n += 1
            if n >= cap:
                break
    return n


def _module_level_bindings(tree: ast.Module):
    """Module-level names bound to big literals / array ctors (RT103)
    and to unserializable resources (RT104)."""
    big: Dict[str, str] = {}
    unser: Dict[str, str] = {}
    for stmt in tree.body:
        if not isinstance(stmt, ast.Assign):
            continue
        targets = [t.id for t in stmt.targets if isinstance(t, ast.Name)]
        if not targets:
            continue
        v = stmt.value
        if isinstance(v, (ast.List, ast.Tuple)) and \
                _const_count(v, LARGE_LITERAL_ELEMS) >= LARGE_LITERAL_ELEMS:
            for t in targets:
                big[t] = "a large literal"
        elif isinstance(v, ast.Call):
            name = dotted(v.func) or ""
            parts = name.split(".")
            if len(parts) >= 2 and parts[0] in ("np", "numpy", "jnp") and \
                    parts[-1] in _ARRAY_CTORS:
                for t in targets:
                    big[t] = f"an array built by {name}()"
            elif name in _UNSERIALIZABLE_CTORS:
                for t in targets:
                    unser[t] = _UNSERIALIZABLE_CTORS[name]
    return big, unser


def _remote_functions(ctx: ModuleContext):
    """(function, is_method_of_remote_class) for every @remote function
    and every method of a @remote class."""
    for node in ctx.nodes(ast.FunctionDef, ast.AsyncFunctionDef):
        if _remote_decorated(node):
            yield node, False
    for node in ctx.nodes(ast.ClassDef):
        if _remote_decorated(node):
            for item in node.body:
                if isinstance(item, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    yield item, True


@register
class NestedBlockingGet(Rule):
    id = "RT101"
    example_bad = (
        "@ray_tpu_torch.remote\n"
        "def outer(ref):\n"
        "    return ray_tpu_torch.get(ref) + 1\n")
    example_good = (
        "@ray_tpu_torch.remote\n"
        "def outer(x):          # take the VALUE\n"
        "    return x + 1\n")
    scope = "user"
    summary = "blocking get() inside a @remote function/actor method"
    rationale = ("A task that blocks on get() occupies its worker while "
                 "waiting for work that needs another worker; under a "
                 "bounded pool, nested gets deadlock.  Restructure so the "
                 "driver composes refs, or pass refs through.")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        mods, gets = _module_aliases(ctx)
        if not mods and not gets:
            return
        for fn, is_method in _remote_functions(ctx):
            where = "actor method" if is_method else "remote function"
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) and \
                        _is_framework_get(node, mods, gets):
                    yield ctx.finding(
                        self, node,
                        f"blocking get() inside {where} {fn.name!r}: "
                        f"nested gets deadlock under a bounded worker "
                        f"pool; pass refs through or restructure")


@register
class GetInLoop(Rule):
    id = "RT102"
    example_bad = (
        "for r in refs:\n"
        "    out.append(ray_tpu_torch.get(r))   # serializes the batch\n")
    example_good = (
        "out = ray_tpu_torch.get(refs)             # one batched get\n")
    scope = "user"
    summary = "get() called per item in a loop over refs"
    rationale = ("get() per loop iteration serializes the whole batch "
                 "(submit-all / get-all or wait() overlaps execution "
                 "with consumption).")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        mods, gets = _module_aliases(ctx)
        if not mods and not gets:
            return
        wait_bound = self._wait_derived(ctx)
        for loop in ctx.nodes(ast.For):
            if not isinstance(loop.target, ast.Name):
                continue
            # Iterating a .remote() call directly consumes a streaming
            # ObjectRefGenerator — per-item get IS the streaming API.
            if isinstance(loop.iter, ast.Call) and \
                    isinstance(loop.iter.func, ast.Attribute) and \
                    loop.iter.func.attr == "remote":
                continue
            # Refs that came back from wait() are already complete:
            # wait-then-get is the recommended pattern, not the bug.
            if isinstance(loop.iter, ast.Name) and \
                    loop.iter.id in wait_bound:
                continue
            lvar = loop.target.id
            for node in walk_same_scope(loop):
                if not (isinstance(node, ast.Call) and
                        _is_framework_get(node, mods, gets)):
                    continue
                if len(node.args) != 1:
                    continue
                arg = node.args[0]
                hits = (isinstance(arg, ast.Name) and arg.id == lvar) or (
                    isinstance(arg, ast.Subscript) and any(
                        isinstance(s, ast.Name) and s.id == lvar
                        for s in ast.walk(arg.slice)))
                if hits:
                    yield ctx.finding(
                        self, node,
                        f"get() on each item of the loop over {lvar!r}: "
                        f"call get() once on the list, or use wait() to "
                        f"overlap completion with consumption")

    @staticmethod
    def _wait_derived(ctx: ModuleContext) -> Set[str]:
        """Names bound (possibly via tuple unpack) from a wait() call."""
        out: Set[str] = set()
        for node in ctx.nodes(ast.Assign):
            if not isinstance(node.value, ast.Call):
                continue
            fname = dotted(node.value.func) or ""
            if fname.split(".")[-1] != "wait":
                continue
            for t in node.targets:
                elts = t.elts if isinstance(t, ast.Tuple) else [t]
                out |= {e.id for e in elts if isinstance(e, ast.Name)}
        return out


@register
class LargeCapture(Rule):
    id = "RT103"
    example_bad = (
        "TABLE = np.zeros((1000, 1000))\n"
        "\n"
        "@ray_tpu_torch.remote\n"
        "def f(i):\n"
        "    return TABLE[i].sum()   # re-shipped per submit\n")
    example_good = (
        "ref = ray_tpu_torch.put(TABLE)   # ship once\n"
        "\n"
        "@ray_tpu_torch.remote\n"
        "def f(table, i):\n"
        "    return table[i].sum()\n")
    scope = "user"
    summary = "large literal/array captured in a remote closure"
    rationale = ("Each .remote() call re-serializes captured arguments; "
                 "put() the object once and pass the ref.")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        big, _unser = _module_level_bindings(ctx.tree)
        # (a) a large literal passed straight into .remote(...)
        for node in ctx.nodes(ast.Call):
            if not (isinstance(node.func, ast.Attribute) and
                    node.func.attr == "remote"):
                continue
            args = list(node.args) + [kw.value for kw in node.keywords]
            for arg in args:
                if isinstance(arg, (ast.List, ast.Tuple)) and \
                        _const_count(arg, LARGE_LITERAL_ELEMS) >= \
                        LARGE_LITERAL_ELEMS:
                    yield ctx.finding(
                        self, arg,
                        "large literal argument to .remote(): put() it "
                        "once and pass the ObjectRef")
        # (b) a module-level array referenced inside a remote function
        # body (captured by the closure serializer on every submit).
        for fn, is_method in _remote_functions(ctx):
            if is_method:
                continue  # actor state lives in one process: fine
            arg_names = {a.arg for a in fn.args.args +
                         fn.args.posonlyargs + fn.args.kwonlyargs}
            for node in ast.walk(fn):
                if isinstance(node, ast.Name) and \
                        isinstance(node.ctx, ast.Load) and \
                        node.id in big and node.id not in arg_names:
                    yield ctx.finding(
                        self, node,
                        f"remote function {fn.name!r} captures "
                        f"module-level {node.id!r} ({big[node.id]}): "
                        f"put() it once and pass the ObjectRef")


@register
class UnserializableCapture(Rule):
    id = "RT104"
    example_bad = (
        "LOCK = threading.Lock()\n"
        "\n"
        "@ray_tpu_torch.remote\n"
        "def f():\n"
        "    with LOCK:              # locks do not pickle\n"
        "        return 1\n")
    example_good = (
        "@ray_tpu_torch.remote\n"
        "def f():\n"
        "    lock = threading.Lock()  # create inside the task\n"
        "    with lock:\n"
        "        return 1\n")
    scope = "user"
    summary = "unserializable object in a .remote() call/closure"
    rationale = ("Locks, file handles and sockets do not survive "
                 "pickling; create them inside the task or hold them in "
                 "actor state.")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        _big, unser = _module_level_bindings(ctx.tree)
        for node in ctx.nodes(ast.Call):
            if not (isinstance(node.func, ast.Attribute) and
                    node.func.attr == "remote"):
                continue
            args = list(node.args) + [kw.value for kw in node.keywords]
            for arg in args:
                kind = None
                if isinstance(arg, ast.Call):
                    kind = _UNSERIALIZABLE_CTORS.get(dotted(arg.func) or "")
                elif isinstance(arg, ast.Name):
                    kind = unser.get(arg.id)
                if kind:
                    yield ctx.finding(
                        self, arg,
                        f"passing {kind} into .remote(): it cannot be "
                        f"serialized; create it inside the task or keep "
                        f"it in actor state")
        for fn, is_method in _remote_functions(ctx):
            if is_method:
                continue
            arg_names = {a.arg for a in fn.args.args +
                         fn.args.posonlyargs + fn.args.kwonlyargs}
            for node in ast.walk(fn):
                if isinstance(node, ast.Name) and \
                        isinstance(node.ctx, ast.Load) and \
                        node.id in unser and node.id not in arg_names:
                    yield ctx.finding(
                        self, node,
                        f"remote function {fn.name!r} captures "
                        f"module-level {node.id!r} ({unser[node.id]}): "
                        f"it cannot be serialized")


@register
class ActorSelfCall(Rule):
    id = "RT105"
    example_bad = (
        "@ray_tpu_torch.remote\n"
        "class A:\n"
        "    def run(self):\n"
        "        return self.step.remote()   # own busy queue\n")
    example_good = (
        "@ray_tpu_torch.remote\n"
        "class A:\n"
        "    def run(self):\n"
        "        return self.step()          # direct call\n")
    scope = "user"
    summary = "actor method .remote()-calls its own actor"
    rationale = ("self.method.remote() from inside the actor targets the "
                 "actor's own (busy) call queue: with max_concurrency=1 "
                 "a blocking wait on the result never completes.  Call "
                 "the method directly, or go through a separate actor.")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ctx.nodes(ast.ClassDef):
            if not _remote_decorated(node):
                continue
            methods = {item.name for item in node.body
                       if isinstance(item, (ast.FunctionDef,
                                            ast.AsyncFunctionDef))}
            for item in node.body:
                if not isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                for call in ast.walk(item):
                    if not (isinstance(call, ast.Call) and
                            isinstance(call.func, ast.Attribute) and
                            call.func.attr == "remote"):
                        continue
                    inner = call.func.value  # self.<m>
                    if isinstance(inner, ast.Attribute) and \
                            isinstance(inner.value, ast.Name) and \
                            inner.value.id == "self" and \
                            inner.attr in methods:
                        yield ctx.finding(
                            self, call,
                            f"actor {node.name!r} submits to itself via "
                            f"self.{inner.attr}.remote(): a blocking "
                            f"wait on the result self-deadlocks; call "
                            f"self.{inner.attr}(...) directly")
