"""Concurrency lint rules (RT4xx): guarded-by inference over classes
(a copy of ray_tpu/devtools/rules_concurrency.py).

The RT2xx lock rules are lexical (a blocking call inside a ``with
lock:`` block).  This family is *semantic*: per class, discover the
lock fields (``self._lock = threading.RLock()``, ``self._wake =
threading.Condition(self._lock)``, class-level ``_lock = Lock()``),
run the lock-held-set CFG analysis (devtools/dataflow.LockAnalysis)
over every method, and infer which attributes are guarded by which
locks — then flag the places where the discipline breaks:

* RT401 — attribute written under a lock at one site, read or written
  bare at another (inconsistent guarding).
* RT402 — check-then-act: ``if self.X: ... self.X = ...`` outside the
  lock that guards ``X``.
* RT403 — lock released (``release()`` / ``cond.wait()``) while
  iterating a shared ``self.*`` container.
* RT404 — callback/publish/IO invoked while holding a hot
  control-plane lock (scheduler/node/store/metrics modules).
* RT405 — a ``_locked``-suffix method called on a path where no lock
  is held.

Interprocedural contract, inferred per class to a fixpoint: public
methods enter with no locks; ``_locked``-suffix methods assume their
callers' locks (intersection over lock-holding internal call sites;
all class locks when never called internally); other private helpers
enter with the intersection of ALL internal call-site held sets.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Set, Tuple

from .dataflow import LockAnalysis, _iter_calls, _node_exprs
from .lint import Finding, ModuleContext, Rule, dotted, register

#: A ``self.X`` whose last segment matches this is lock machinery, not
#: guarded data.
_LOCKISH_RE = re.compile(r"(lock|cond|mutex|cv|sem|wake|event)",
                         re.IGNORECASE)

#: Quick textual screen: a class whose source never constructs a lock
#: is skipped wholesale (the analysis must fit the lint wall budget).
_LOCK_CTOR_RE = re.compile(r"\b(?:R?Lock|Condition)\s*\(")

#: Method calls that mutate their receiver (write classification).
_MUTATORS = {"append", "appendleft", "add", "clear", "discard", "extend",
             "insert", "pop", "popleft", "popitem", "remove", "update",
             "setdefault", "sort"}

#: Modules whose locks are on the control-plane hot path (RT404).
HOT_LOCK_MODULES = (
    "ray_tpu_torch/_scheduler.py",
    "ray_tpu_torch/_tasks.py",
    "ray_tpu_torch/_object_store.py",
    "util/metrics.py",
    "metricsview/__init__.py",
)

#: telemetry publish entry points (RT404).
_PUBLISH_FNS = {"inc", "observe", "set_gauge", "observe_many"}
_PUBLISH_RECEIVERS = {"telemetry", "metrics"}

#: Socket/pipe IO that can block on a slow peer (RT404).
_IO_ATTRS = {"send", "sendall", "sendto", "publish", "emit"}

_FIXPOINT_MAX = 10


# --------------------------------------------------------------------------
# per-class analysis
# --------------------------------------------------------------------------


@dataclass
class _Access:
    attr: str
    kind: str            # "read" | "write"
    line: int
    col: int
    held: frozenset
    method: str
    node: ast.AST


@dataclass
class _ClassInfo:
    cls: ast.ClassDef
    locks: Set[str]                      # canonical ("self._lock")
    aliases: Dict[str, str]              # "self._wake" -> "self._lock"
    methods: Dict[str, ast.AST] = field(default_factory=dict)
    analyses: Dict[str, LockAnalysis] = field(default_factory=dict)
    entry: Dict[str, frozenset] = field(default_factory=dict)
    held: Dict[str, Dict[int, frozenset]] = field(default_factory=dict)
    accesses: List[_Access] = field(default_factory=list)


def _lock_decls(cls: ast.ClassDef) -> Tuple[Set[str], Dict[str, str]]:
    """Lock fields + aliases for one class.  Condition-on-a-lock is an
    alias of that lock (entering the condition enters the lock); a bare
    ``Condition()`` owns its own hidden lock and counts as one."""
    locks: Set[str] = set()
    aliases: Dict[str, str] = {}
    conds: List[Tuple[str, Optional[str]]] = []
    for node in ast.walk(cls):
        if not isinstance(node, ast.Assign) or \
                not isinstance(node.value, ast.Call):
            continue
        ctor = dotted(node.value.func) or ""
        seg = ctor.split(".")[-1]
        for t in node.targets:
            name = dotted(t)
            if name is None:
                continue
            if not name.startswith(("self.", "cls.")) and "." in name:
                continue
            canon = "self." + name.split(".", 1)[1] if "." in name \
                else "self." + name
            if seg in ("Lock", "RLock"):
                locks.add(canon)
                if "." not in name:  # class-level: reachable as cls.X too
                    aliases["cls." + name] = canon
                    aliases[f"{cls.name}.{name}"] = canon
            elif seg == "Condition":
                arg = node.value.args[0] if node.value.args else None
                conds.append((canon, dotted(arg) if arg is not None
                              else None))
    for canon, target in conds:
        if target is not None and target in locks:
            aliases[canon] = target
        else:
            locks.add(canon)  # Condition() with its own lock
    return locks, aliases


def _own_methods(cls: ast.ClassDef) -> Dict[str, ast.AST]:
    out: Dict[str, ast.AST] = {}
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            args = node.args.posonlyargs + node.args.args
            if args and args[0].arg == "self":
                out[node.name] = node
    return out


def _walk_expr(expr: ast.AST) -> Iterator[ast.AST]:
    """Walk an expression without entering nested def/lambda bodies."""
    stack = [expr]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda, ast.ClassDef)):
                continue
            stack.append(child)


def _self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _iter_node_accesses(cfg_node, held: frozenset, method: str
                        ) -> Iterator[_Access]:
    """``self.X`` reads/writes that execute at one CFG node."""
    stmt = cfg_node.stmt
    if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return
    for expr in _node_exprs(cfg_node):
        for sub in _walk_expr(expr):
            attr = _self_attr(sub)
            if attr is not None:
                kind = "write" if isinstance(sub.ctx, (ast.Store,
                                                       ast.Del)) \
                    else "read"
                yield _Access(attr, kind, sub.lineno,
                              sub.col_offset, held, method, sub)
            if isinstance(sub, ast.Subscript) and \
                    isinstance(sub.ctx, (ast.Store, ast.Del)):
                a = _self_attr(sub.value)
                if a is not None:
                    yield _Access(a, "write", sub.lineno,
                                  sub.col_offset, held, method, sub)
            if isinstance(sub, ast.Call) and \
                    isinstance(sub.func, ast.Attribute) and \
                    sub.func.attr in _MUTATORS:
                a = _self_attr(sub.func.value)
                if a is not None:
                    yield _Access(a, "write", sub.lineno,
                                  sub.col_offset, held, method, sub)


def _initial_entry(name: str, locks: Set[str]) -> frozenset:
    if name.endswith("_locked"):
        return frozenset(locks)
    if name.startswith("_") and not name.startswith("__"):
        return frozenset(locks)  # optimistic; fixpoint shrinks it
    return frozenset()


def _infer_class(info: _ClassInfo) -> None:
    """Run the per-class entry-assumption fixpoint, then record final
    held maps and attribute accesses."""
    locks = info.locks
    for name, fn in info.methods.items():
        info.analyses[name] = LockAnalysis(fn, locks, info.aliases)
        info.entry[name] = _initial_entry(name, locks)
    for _round in range(_FIXPOINT_MAX):
        # held maps under the current entry assumptions
        for name, la in info.analyses.items():
            info.held[name] = la.held_map(info.entry[name])
        # internal call sites: method -> held sets observed at calls
        sites: Dict[str, List[frozenset]] = {}
        for name, la in info.analyses.items():
            hm = info.held[name]
            for n in la.cfg.nodes:
                for expr in _node_exprs(n):
                    for call in _iter_calls(expr):
                        callee = _self_attr(call.func)
                        if callee in info.methods:
                            sites.setdefault(callee, []).append(
                                hm[n.idx])
        changed = False
        for name in info.methods:
            if not name.startswith("_") or name.startswith("__"):
                continue
            seen = sites.get(name, [])
            if name.endswith("_locked"):
                # Contract methods: bad (lock-free) call sites are
                # RT405's to flag, not grounds to drop the assumption.
                seen = [h for h in seen if h]
                new = frozenset.intersection(*seen) if seen \
                    else frozenset(locks)
            else:
                new = frozenset.intersection(*seen) if seen \
                    else frozenset()
            if new != info.entry[name]:
                info.entry[name] = new
                changed = True
        if not changed:
            break
    for name, la in info.analyses.items():
        hm = info.held[name]
        for n in la.cfg.nodes:
            info.accesses.extend(_iter_node_accesses(n, hm[n.idx], name))


def _class_infos(ctx: ModuleContext) -> List[_ClassInfo]:
    """Analyzed lock-owning classes of one module, cached on the ctx
    (five rules share one pass)."""
    cached = getattr(ctx, "_rt4_classes", None)
    if cached is not None:
        return cached
    out: List[_ClassInfo] = []
    if _LOCK_CTOR_RE.search(ctx.source):
        for cls in ctx.nodes(ast.ClassDef):
            end = getattr(cls, "end_lineno", None) or len(ctx.lines)
            seg = "\n".join(ctx.lines[cls.lineno - 1:end])
            if not _LOCK_CTOR_RE.search(seg):
                continue
            locks, aliases = _lock_decls(cls)
            if not locks:
                continue
            info = _ClassInfo(cls, locks, aliases)
            info.methods = _own_methods(cls)
            _infer_class(info)
            out.append(info)
    ctx._rt4_classes = out
    return out


def _fmt_locks(held: frozenset) -> str:
    return ", ".join(sorted(held))


def _is_ctor_method(name: str) -> bool:
    # Construction and finalization run before/after the object is
    # shared; their bare accesses are not evidence of a race.
    return name in ("__init__", "__new__", "__del__", "__post_init__")


# --------------------------------------------------------------------------
# rules
# --------------------------------------------------------------------------


@register
class InconsistentlyGuardedAttr(Rule):
    id = "RT401"
    scope = "internal"
    dataflow = True
    summary = "attribute guarded by a lock at one site, bare at another"
    rationale = ("If `self.x` is written under `self._lock` anywhere, "
                 "every other read/write races with that critical "
                 "section unless it holds the same lock; guard every "
                 "access (or suppress with a justification for benign "
                 "racy reads).  Inferred per class across methods, "
                 "including `_locked`-contract and private-helper call "
                 "sites; one finding per attribute, anchored at the "
                 "first bare site.")
    example_bad = (
        "class S:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self._q = []\n"
        "    def put(self, x):\n"
        "        with self._lock:\n"
        "            self._q.append(x)\n"
        "    def drain(self):\n"
        "        out, self._q = self._q, []   # bare: races with put()\n"
        "        return out\n")
    example_good = (
        "    def drain(self):\n"
        "        with self._lock:\n"
        "            out, self._q = self._q, []\n"
        "        return out\n")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for info in _class_infos(ctx):
            guarded: Dict[str, Tuple[frozenset, str]] = {}
            bare: Dict[str, List[_Access]] = {}
            for acc in info.accesses:
                if _is_ctor_method(acc.method) or \
                        _LOCKISH_RE.search(acc.attr):
                    continue
                if acc.kind == "write" and acc.held:
                    if acc.attr not in guarded:
                        guarded[acc.attr] = (acc.held, acc.method)
                if not acc.held:
                    bare.setdefault(acc.attr, []).append(acc)
            for attr, (held, method) in sorted(guarded.items()):
                raw = bare.get(attr)
                if not raw:
                    continue
                # A mutator call yields both the attribute load and the
                # write — count each source location once.
                sites = list({(a.line, a.col): a for a in raw}.values())
                first = min(sites, key=lambda a: (a.line, a.col))
                yield ctx.finding(
                    self, first.node,
                    f"self.{attr} is written under {_fmt_locks(held)} "
                    f"(e.g. in {method}()) but accessed bare here — "
                    f"{len(sites)} bare site(s) in class "
                    f"{info.cls.name}; hold the lock at every access")


@register
class CheckThenActOutsideLock(Rule):
    id = "RT402"
    scope = "internal"
    dataflow = True
    summary = "check-then-act on a guarded attribute outside its lock"
    rationale = ("Testing a lock-guarded attribute and then updating it "
                 "without holding the lock is a TOCTOU race: another "
                 "thread can invalidate the check before the act "
                 "commits.  Take the lock around the whole "
                 "test-and-update.")
    example_bad = (
        "if self._leader is None:        # bare check\n"
        "    self._leader = me           # bare act: two winners\n")
    example_good = (
        "with self._lock:\n"
        "    if self._leader is None:\n"
        "        self._leader = me\n")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for info in _class_infos(ctx):
            guarded: Set[str] = {
                acc.attr for acc in info.accesses
                if acc.kind == "write" and acc.held and
                not _is_ctor_method(acc.method)}
            if not guarded:
                continue
            for name, la in info.analyses.items():
                if _is_ctor_method(name):
                    continue
                hm = info.held[name]
                for n in la.cfg.nodes:
                    if n.kind != "stmt" or not isinstance(n.stmt, ast.If) \
                            or hm[n.idx]:
                        continue
                    tested = {a for sub in _walk_expr(n.stmt.test)
                              if (a := _self_attr(sub)) in guarded}
                    if not tested:
                        continue
                    acted = self._written_in_body(n.stmt.body)
                    for attr in sorted(tested & acted):
                        lock = next(
                            (_fmt_locks(acc.held) for acc in info.accesses
                             if acc.attr == attr and acc.held), "its lock")
                        yield ctx.finding(
                            self, n.stmt,
                            f"check-then-act on self.{attr} outside "
                            f"{lock}: the test and the update must be "
                            f"one critical section")

    @staticmethod
    def _written_in_body(body: List[ast.stmt]) -> Set[str]:
        out: Set[str] = set()
        for stmt in body:
            for sub in ast.walk(stmt):
                if isinstance(sub, (ast.FunctionDef,
                                    ast.AsyncFunctionDef, ast.Lambda)):
                    continue
                a = _self_attr(sub)
                if a is not None and isinstance(sub.ctx, ast.Store):
                    out.add(a)
                if isinstance(sub, ast.Subscript) and \
                        isinstance(sub.ctx, (ast.Store, ast.Del)):
                    a = _self_attr(sub.value)
                    if a is not None:
                        out.add(a)
                if isinstance(sub, ast.Call) and \
                        isinstance(sub.func, ast.Attribute) and \
                        sub.func.attr in _MUTATORS:
                    a = _self_attr(sub.func.value)
                    if a is not None:
                        out.add(a)
        return out


@register
class LockReleasedMidIteration(Rule):
    id = "RT403"
    scope = "internal"
    dataflow = True
    summary = "lock released while iterating a shared container"
    rationale = ("Releasing the guarding lock (bare release() or a "
                 "Condition wait(), which releases it) inside a loop "
                 "over a shared `self.*` container lets another thread "
                 "mutate the container mid-iteration — RuntimeError at "
                 "best, silent skips at worst.  Snapshot under the "
                 "lock, release, then iterate the snapshot.")
    example_bad = (
        "with self._lock:\n"
        "    for k in self._waiters:\n"
        "        self._lock.release()   # waiter can mutate dict\n"
        "        notify(k)\n"
        "        self._lock.acquire()\n")
    example_good = (
        "with self._lock:\n"
        "    waiters = list(self._waiters)\n"
        "for k in waiters:\n"
        "    notify(k)\n")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for info in _class_infos(ctx):
            for name, la in info.analyses.items():
                hm = info.held[name]
                for n in la.cfg.nodes:
                    if n.kind != "loop-head" or \
                            not isinstance(n.stmt, (ast.For,
                                                    ast.AsyncFor)):
                        continue
                    container = next(
                        (a for sub in _walk_expr(n.stmt.iter)
                         if (a := _self_attr(sub)) is not None
                         and not _LOCKISH_RE.search(a)), None)
                    if container is None or not hm[n.idx]:
                        continue
                    for rel, lock in self._releases(n.stmt.body, la):
                        if lock in hm[n.idx]:
                            yield ctx.finding(
                                self, rel,
                                f"{lock} released mid-iteration over "
                                f"self.{container}: snapshot the "
                                f"container, release, then iterate",
                                anchors=(n.stmt,))

    @staticmethod
    def _releases(body: List[ast.stmt], la: LockAnalysis
                  ) -> Iterator[Tuple[ast.Call, str]]:
        for stmt in body:
            for call in _iter_calls(stmt):
                if not isinstance(call.func, ast.Attribute):
                    continue
                if call.func.attr not in ("release", "wait", "wait_for"):
                    continue
                lock = la.resolve(call.func.value)
                if lock is not None:
                    yield call, lock


@register
class CallbackUnderHotLock(Rule):
    id = "RT404"
    scope = "internal"
    dataflow = True
    summary = "callback/publish/IO while holding a hot control-plane lock"
    rationale = ("Scheduler/node/store/metrics locks sit on the "
                 "decision path of every task; invoking a callback, a "
                 "telemetry publish, or socket IO while holding one "
                 "convoys all contenders behind arbitrary downstream "
                 "work (and a callback that re-enters the lock "
                 "deadlocks a plain Lock).  Collect what to publish "
                 "under the lock, invoke after release — the "
                 "off-lock-publish pattern.")
    example_bad = (
        "with self._lock:\n"
        "    t = self._ready.popleft()\n"
        "    self.on_stage(t.id, STAGE_READY)   # user code under lock\n")
    example_good = (
        "with self._lock:\n"
        "    t = self._ready.popleft()\n"
        "self.on_stage(t.id, STAGE_READY)       # after release\n")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if not ctx.module_key.endswith(HOT_LOCK_MODULES):
            return
        for info in _class_infos(ctx):
            for name, la in info.analyses.items():
                hm = info.held[name]
                for n in la.cfg.nodes:
                    if not hm[n.idx]:
                        continue
                    for expr in _node_exprs(n):
                        for call in _iter_calls(expr):
                            label = self._label(call)
                            if label:
                                yield ctx.finding(
                                    self, call,
                                    f"{label} while holding "
                                    f"{_fmt_locks(hm[n.idx])}: collect "
                                    f"under the lock, invoke after "
                                    f"release (off-lock publish)")

    @staticmethod
    def _label(call: ast.Call) -> Optional[str]:
        func = call.func
        if not isinstance(func, ast.Attribute):
            return None
        attr = func.attr
        recv = dotted(func.value) or ""
        recv_seg = recv.split(".")[-1]
        if attr in _PUBLISH_FNS and recv_seg in _PUBLISH_RECEIVERS:
            return f"{recv}.{attr}() publish"
        if attr.startswith("on_") or attr.endswith(("_callback", "_cb")):
            return f"{recv}.{attr}() callback" if recv else \
                f"{attr}() callback"
        if attr in _IO_ATTRS and recv_seg not in _PUBLISH_RECEIVERS:
            return f"{recv}.{attr}() IO"
        return None


@register
class LockedSuffixCalledBare(Rule):
    id = "RT405"
    scope = "internal"
    dataflow = True
    summary = "`_locked`-suffix method called without holding a lock"
    rationale = ("The `_locked` suffix is the documented contract "
                 "\"caller already holds the guarding lock\"; a call "
                 "site where no class lock is held on ANY path breaks "
                 "the contract silently — the method mutates shared "
                 "state unguarded.")
    example_bad = (
        "def kick(self):\n"
        "    self._push_ready_locked(t)   # no lock held\n")
    example_good = (
        "def kick(self):\n"
        "    with self._lock:\n"
        "        self._push_ready_locked(t)\n")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for info in _class_infos(ctx):
            for name, la in info.analyses.items():
                hm = info.held[name]
                for n in la.cfg.nodes:
                    for expr in _node_exprs(n):
                        for call in _iter_calls(expr):
                            callee = _self_attr(call.func)
                            if callee is None or \
                                    not callee.endswith("_locked"):
                                continue
                            if not hm[n.idx]:
                                yield ctx.finding(
                                    self, call,
                                    f"self.{callee}() called with no "
                                    f"lock held: the `_locked` suffix "
                                    f"means the caller must hold the "
                                    f"guarding lock")
