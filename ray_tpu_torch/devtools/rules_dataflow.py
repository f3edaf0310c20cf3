"""Dataflow-backed lint rules (RT3xx): resource-lifecycle invariants
(a copy of ray_tpu/devtools/rules_dataflow.py).

Unlike the single-node RT1xx/RT2xx rules these run over the per-function
CFG built by :mod:`ray_tpu_torch.devtools.dataflow` — a leak is a *path*
property (``try_pin`` on one branch, ``try_unpin`` missing on the
exception branch).  They are internal-scope: the framework's own
acquire/release pairs are the table they check.

* RT301 — resource acquired but not released on **all** paths (pins,
  bare ``lock.acquire()``, ``open()`` without ``with``/``close``,
  ``threading.Thread(...).start()`` with no reachable ``join``/tracked
  registration — fire-and-forget framework threads go through
  ``ray_tpu_torch._sanitizer.spawn``).
* RT302 — ObjectRef obtained but neither gotten, awaited, passed on nor
  stored; deliberate fire-and-forget is spelled ``# ray-tpu: detached``.
* RT303 — KV key written under a dynamic prefix with no matching
  delete/GC anywhere in the same subsystem directory.
* RT304 — the ``except`` path skips a release the happy path performs
  (the exact shape of the "dead worker leaks one pinned blob" class).
"""

from __future__ import annotations

import ast
import os
from typing import Dict, Iterator, List, Optional, Set, Tuple

from . import dataflow
from .lint import Finding, ModuleContext, Rule, register, walk_same_scope

#: Marker that makes a fire-and-forget ObjectRef explicit (RT302).
DETACHED_MARKER = "ray-tpu: detached"

_FAMILY_HINT = {
    "pin": "unpin it on every path (finally/except included)",
    "lock": "release() on every path — or use `with`",
    "file": "close() on every path — or use `with open(...)`",
    "thread": "join() it, store it, or spawn it through "
              "ray_tpu_torch._sanitizer.spawn (tracked registry)",
}


def _function_leaks(ctx: ModuleContext):
    """One dataflow pass per module, shared by RT301/RT304."""
    cached = getattr(ctx, "_rt3_leaks", None)
    if cached is None:
        cached = []
        for fn in ctx.nodes(ast.FunctionDef, ast.AsyncFunctionDef):
            for leak in dataflow.analyze_function(fn):
                cached.append((fn, leak))
        ctx._rt3_leaks = cached
    return cached


@register
class ResourceNotReleased(Rule):
    id = "RT301"
    scope = "internal"
    dataflow = True
    summary = "resource acquired but not released on all paths"
    rationale = ("An acquire (pin / lock.acquire / open / Thread.start) "
                 "with a path to function exit that never releases it "
                 "leaks one resource per call — invisible per-node, "
                 "fatal to long-run goodput.")
    example_bad = (
        "def stage(store, oid, flag):\n"
        "    store.try_pin(oid)\n"
        "    if flag:\n"
        "        return None      # leaks the pin\n"
        "    store.try_unpin(oid)\n")
    example_good = (
        "def stage(store, oid, flag):\n"
        "    store.try_pin(oid)\n"
        "    try:\n"
        "        if flag:\n"
        "            return None\n"
        "    finally:\n"
        "        store.try_unpin(oid)\n")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for fn, leak in _function_leaks(ctx):
            if leak.kind != "all-paths":
                continue
            res = leak.resource
            yield ctx.finding(
                self, res.call,
                f"{res.label} in {fn.name}(): acquired but not released "
                f"on every path — {_FAMILY_HINT[res.family]}")


@register
class ExceptPathSkipsRelease(Rule):
    id = "RT304"
    scope = "internal"
    dataflow = True
    summary = "except path skips the release the happy path performs"
    rationale = ("The happy path releases (or hands off) the resource; "
                 "an except handler between acquire and release that "
                 "returns/raises without releasing leaks exactly when "
                 "something already went wrong — the least-tested path.")
    example_bad = (
        "ref = put(blob)\n"
        "_control(\"pin_object\", ref.binary())\n"
        "try:\n"
        "    kv_put(key, ref)\n"
        "except Exception:\n"
        "    return           # pin leaks when the KV write fails\n"
        "self._pinned = ref\n")
    example_good = (
        "ref = put(blob)\n"
        "_control(\"pin_object\", ref.binary())\n"
        "try:\n"
        "    kv_put(key, ref)\n"
        "except Exception:\n"
        "    _control(\"unpin_object\", ref.binary())\n"
        "    return\n"
        "self._pinned = ref\n")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for fn, leak in _function_leaks(ctx):
            if leak.kind != "except-path":
                continue
            res = leak.resource
            handler = f" (handler at line {leak.handler_line})" \
                if leak.handler_line else ""
            f = ctx.finding(
                self, res.call,
                f"{res.label} in {fn.name}(): the except path{handler} "
                f"exits without the release the happy path performs — "
                f"release in the handler or a finally")
            # Suppressible at the acquire line or the handler line.
            if leak.handler_line:
                f = Finding(f.rule, f.path, f.line, f.col, f.message,
                            f.anchor_lines + (leak.handler_line,))
            yield f


@register
class DanglingObjectRef(Rule):
    id = "RT302"
    scope = "internal"
    dataflow = True
    summary = "ObjectRef obtained but never consumed, stored or marked " \
              "detached"
    rationale = ("A `.remote()` result that is neither gotten, awaited, "
                 "passed on nor stored pins its task's output in the "
                 "object store until job end and silently swallows the "
                 "task's errors; deliberate fire-and-forget must say so "
                 "with `# ray-tpu: detached`.")
    example_bad = "h.refresh.remote()   # result and errors dropped\n"
    example_good = ("h.refresh.remote()  # ray-tpu: detached — "
                    "best-effort cache warm\n")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        scopes: List[ast.AST] = [ctx.tree]
        scopes += ctx.nodes(ast.FunctionDef, ast.AsyncFunctionDef)
        for scope in scopes:
            yield from self._check_scope(ctx, scope)

    def _check_scope(self, ctx: ModuleContext,
                     scope: ast.AST) -> Iterator[Finding]:
        for stmt in walk_same_scope(scope):
            if isinstance(stmt, ast.Expr) and \
                    self._is_remote_call(stmt.value):
                if self._detached(ctx, stmt.lineno):
                    continue
                yield ctx.finding(
                    self, stmt,
                    "`.remote()` result discarded: get/await/store the "
                    "ref, or mark deliberate fire-and-forget with "
                    "`# ray-tpu: detached`")
            elif isinstance(stmt, ast.Assign) and \
                    len(stmt.targets) == 1 and \
                    isinstance(stmt.targets[0], ast.Name) and \
                    stmt.targets[0].id != "_" and \
                    self._is_remote_call(stmt.value):
                name = stmt.targets[0].id
                if self._detached(ctx, stmt.lineno):
                    continue
                if not self._used_later(scope, stmt, name):
                    yield ctx.finding(
                        self, stmt,
                        f"ObjectRef bound to `{name}` is never used: "
                        f"get/await/store it, or mark the line "
                        f"`# ray-tpu: detached`")

    @staticmethod
    def _is_remote_call(node: ast.AST) -> bool:
        return isinstance(node, ast.Call) and \
            isinstance(node.func, ast.Attribute) and \
            node.func.attr == "remote"

    @staticmethod
    def _detached(ctx: ModuleContext, lineno: int) -> bool:
        if 1 <= lineno <= len(ctx.lines):
            return DETACHED_MARKER in ctx.lines[lineno - 1]
        return False

    @staticmethod
    def _used_later(scope: ast.AST, assign: ast.Assign, name: str) -> bool:
        # Loads of the name AFTER the binding (a Load before it consumed
        # a previous binding's ref, so a rebinding whose result is never
        # read must still be flagged).  Inside a loop execution order is
        # circular — a textually earlier Load runs after the rebinding
        # on the next iteration — so any Load in the scope counts then.
        # Nested defs are included either way: closures legitimately
        # consume the ref later.
        in_loop = any(
            n.lineno <= assign.lineno <= getattr(n, "end_lineno",
                                                 n.lineno)
            for n in ast.walk(scope)
            if isinstance(n, (ast.For, ast.AsyncFor, ast.While)))
        for node in ast.walk(scope):
            if isinstance(node, ast.Name) and node.id == name and \
                    isinstance(node.ctx, ast.Load) and \
                    (in_loop or node.lineno > assign.lineno):
                return True
        return False


# -- RT303: KV prefix hygiene ----------------------------------------------


def _kv_call_kind(call: ast.Call) -> Optional[Tuple[str, ast.AST]]:
    """("put"|"del", key_expr) for any of the KV write/delete shapes:
    ``kv_put(...)`` / ``ctl_kv_put(...)`` / ``_kv_put(...)`` helpers and
    ``_control("kv_put", key, ...)``."""
    seg = None
    if isinstance(call.func, ast.Attribute):
        seg = call.func.attr
    elif isinstance(call.func, ast.Name):
        seg = call.func.id
    if seg is None:
        return None
    if seg == "_control" and call.args and \
            isinstance(call.args[0], ast.Constant):
        verb = call.args[0].value
        if verb in ("kv_put", "kv_del") and len(call.args) > 1:
            return ("put" if verb == "kv_put" else "del", call.args[1])
        return None
    if seg.endswith("kv_put") and call.args:
        return ("put", call.args[0])
    if seg.endswith("kv_del") or seg.endswith("kv_delete_prefix"):
        if call.args:
            return ("del", call.args[0])
    return None


def _module_consts(tree: ast.Module) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                isinstance(node.value, ast.Constant) and \
                isinstance(node.value.value, str):
            out[node.targets[0].id] = node.value.value
    return out


def _key_prefix(expr: ast.AST,
                consts: Dict[str, str]) -> Tuple[Optional[str], bool]:
    """(leading literal prefix, fully_literal).  ``(None, False)`` =
    statically unresolvable (variable/call-built key)."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return expr.value, True
    if isinstance(expr, ast.Name):
        v = consts.get(expr.id)
        return (v, True) if v is not None else (None, False)
    if isinstance(expr, ast.JoinedStr):
        prefix = ""
        for part in expr.values:
            if isinstance(part, ast.Constant) and \
                    isinstance(part.value, str):
                prefix += part.value
            else:
                return (prefix or None), False
        return prefix, True
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Add):
        left, lf = _key_prefix(expr.left, consts)
        if left is None:
            return None, False
        if not lf:
            return left, False
        right, rf = _key_prefix(expr.right, consts)
        return left + (right or ""), lf and rf and right is not None
    return None, False


def _collect_kv(tree: ast.Module, consts: Dict[str, str]):
    """(puts, del_prefixes, del_wildcard) for one module."""
    puts: List[Tuple[ast.Call, str]] = []
    dels: Set[str] = set()
    wildcard = False
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        kind = _kv_call_kind(node)
        if kind is None:
            continue
        which, key = kind
        prefix, fully = _key_prefix(key, consts)
        if which == "put":
            # Fully-literal keys are bounded singletons (a verdict slot,
            # a registry blob) — only dynamic keys can accumulate.
            if prefix and not fully:
                puts.append((node, prefix))
        else:
            if prefix:
                dels.add(prefix)
            else:
                wildcard = True  # generic GC loop (key from kv_keys())
    return puts, dels, wildcard


_subsystem_cache: Dict[str, Tuple[Set[str], bool]] = {}


def _subsystem_dels(dirpath: str) -> Tuple[Set[str], bool]:
    """Delete prefixes declared anywhere in the module's directory (the
    subsystem: ray_tpu_torch/train, ray_tpu_torch/serve, ...).  Cached per dir."""
    cached = _subsystem_cache.get(dirpath)
    if cached is not None:
        return cached
    dels: Set[str] = set()
    wildcard = False
    try:
        fnames = sorted(os.listdir(dirpath))
    except OSError:
        fnames = []
    for fname in fnames:
        if not fname.endswith(".py"):
            continue
        try:
            with open(os.path.join(dirpath, fname),
                      encoding="utf-8", errors="replace") as f:
                tree = ast.parse(f.read())
        except (OSError, SyntaxError):
            continue
        _, file_dels, file_wild = _collect_kv(tree, _module_consts(tree))
        dels |= file_dels
        wildcard = wildcard or file_wild
    _subsystem_cache[dirpath] = (dels, wildcard)
    return dels, wildcard


@register
class KvPrefixNeverDeleted(Rule):
    id = "RT303"
    scope = "internal"
    dataflow = True
    summary = "KV key written under a prefix with no delete/GC in the " \
              "same subsystem"
    rationale = ("A per-run/per-rank KV key (dynamic suffix) written "
                 "with no kv_del under a matching prefix anywhere in "
                 "its subsystem grows the head's KV store forever — "
                 "every run leaks its keys into the next.")
    example_bad = ("_control(\"kv_put\", f\"myfeat/{run_id}/x\", blob)\n"
                   "# ... no kv_del under myfeat/ anywhere\n")
    example_good = ("_control(\"kv_put\", f\"myfeat/{run_id}/x\", blob)\n"
                    "# consumer, after processing:\n"
                    "_control(\"kv_del\", key)  # generic GC of read "
                    "keys\n")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if "kv_put" not in ctx.source:
            return
        consts = _module_consts(ctx.tree)
        puts, local_dels, local_wild = _collect_kv(ctx.tree, consts)
        if not puts:
            return
        dirpath = os.path.dirname(os.path.abspath(ctx.path)) \
            if os.path.exists(ctx.path) else None
        if dirpath is not None:
            sub_dels, sub_wild = _subsystem_dels(dirpath)
        else:  # snippet: only the module itself is visible
            sub_dels, sub_wild = local_dels, local_wild
        for call, prefix in puts:
            if sub_wild or any(prefix.startswith(d) or d.startswith(prefix)
                               for d in sub_dels):
                continue
            yield ctx.finding(
                self, call,
                f"KV keys under {prefix!r} are written but never "
                f"deleted in this subsystem: add a kv_del/GC for the "
                f"prefix (consumed keys, end-of-run sweep), or the head "
                f"KV grows per run")
