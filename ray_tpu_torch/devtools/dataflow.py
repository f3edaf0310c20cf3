"""Per-function control-flow graph + acquire/release dataflow analysis (a
copy of ray_tpu/devtools/dataflow.py).

The RT1xx/RT2xx rules match single AST nodes; a leaked resource is a
*path* property — ``try_pin`` on one branch whose ``try_unpin`` is
skipped on the exception branch is invisible node-by-node.  This module
gives the lint engine paths:

* :func:`build_cfg` lowers one function body to a CFG of per-statement
  nodes with labelled edges: branches, loop back-edges, ``with``
  enter/exit markers, ``try``/``except``/``finally`` (exception edges
  from every statement in a protected body to its handlers, ``finally``
  blocks instantiated per exit path so a ``return`` inside ``try`` still
  runs them), and early ``return``/``raise``/``break``/``continue``.
* :func:`_node_exprs` / :func:`_node_calls`: what runs *at* one node
  (the port's RT504 in ``rules_torch`` walks the paths from a scratch
  call over them).
* :func:`analyze_function` pairs acquisition sites against the
  :data:`PAIRED_APIS` table and walks the CFG: a resource must be
  *settled* — released by its paired call, or escaped (stored into an
  attribute/container, returned, passed to another callable) — on every
  path from the acquire to the function exit.  Paths that leak only
  through an ``except`` handler are classified separately (RT304) from
  paths that leak on plain control flow (RT301).
* :class:`LockAnalysis` / :func:`lock_held_map`: which locks are held at
  each node (the RT4xx family in ``rules_concurrency``).

Exception model: calls are assumed not to raise *except* inside a
``try`` body, where every statement gets an edge to the enclosing
handlers/``finally`` — the places where the code itself acknowledges
exceptions are exactly the places where cleanup bugs hide.  Modelling
every call as throwing would flag nearly all straight-line code and
drown the signal.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

#: Acquire call name (last dotted segment) -> matching release names.
#: ``_control("pin_object", ...)`` style string-verb pairs are handled
#: separately (see _CTL_PAIRS).
PAIRED_APIS: Dict[str, Tuple[str, ...]] = {
    "try_pin": ("try_unpin",),
    "ctl_pin_object": ("ctl_unpin_object",),
}

#: First-argument string verbs of ``_control(...)`` forming a pair.
_CTL_PAIRS: Dict[str, str] = {"pin_object": "unpin_object"}

_CTL_NAMES = ("_control",)


# --------------------------------------------------------------------------
# CFG
# --------------------------------------------------------------------------


@dataclass
class Node:
    idx: int
    #: "entry" | "exit" | "stmt" | "loop-head" | "with" | "with-exit" |
    #: "except" | "finally"
    kind: str
    stmt: Optional[ast.AST] = None

    @property
    def line(self) -> int:
        return getattr(self.stmt, "lineno", 0)


class CFG:
    """Edges are ``(dst, label)`` with label "normal" or "exc" — leak
    searches start from an acquire's *normal* successors (a call that
    raised never acquired) but traverse both kinds afterwards."""

    def __init__(self) -> None:
        self.nodes: List[Node] = []
        self.succ: Dict[int, Set[Tuple[int, str]]] = {}
        self.entry = 0
        self.exit = 0

    def add(self, kind: str, stmt: Optional[ast.AST] = None) -> int:
        n = Node(len(self.nodes), kind, stmt)
        self.nodes.append(n)
        self.succ[n.idx] = set()
        return n.idx

    def edge(self, a: int, b: int, label: str = "normal") -> None:
        self.succ[a].add((b, label))

    def successors(self, idx: int,
                   labels: Sequence[str] = ("normal", "exc")) -> List[int]:
        return [b for b, lab in self.succ[idx] if lab in labels]

    def nodes_of_kind(self, kind: str) -> List[Node]:
        return [n for n in self.nodes if n.kind == kind]


class _Builder:
    def __init__(self, fn: ast.AST):
        self.fn = fn
        self.cfg = CFG()
        self.entry = self.cfg.entry = self.cfg.add("entry")
        self.exit = self.cfg.exit = self.cfg.add("exit")
        #: Innermost-last stack of {"kind": "loop"|"try", ...} frames.
        self.frames: List[dict] = []

    # -- helpers -----------------------------------------------------------

    def _connect(self, preds: Set[int], node: int,
                 label: str = "normal") -> None:
        for p in preds:
            self.cfg.edge(p, node, label)

    def _exc_edges(self, node: int) -> None:
        """Edges for an exception raised at ``node``: to the innermost
        enclosing try's handlers (through the exceptional instances of
        any finally-only frames crossed); uncaught -> function exit."""
        i = len(self.frames) - 1
        preds = {node}
        label = "exc"
        while i >= 0:
            f = self.frames[i]
            if f["kind"] == "try" and f.get("protecting"):
                if f["handlers"]:
                    for h in f["handlers"]:
                        self._connect(preds, h, label)
                    return
                if f["final"]:
                    # finally-only frame: route through a per-path copy
                    # of the finally body, then keep propagating.
                    preds = self._finally_copy(f, preds, upto=i, label=label)
                    label = "normal"  # downstream of the copy
            i -= 1
        self._connect(preds, self.exit, label)

    def _finally_copy(self, frame: dict, preds: Set[int], upto: int,
                      label: str = "normal") -> Set[int]:
        """Instantiate ``frame``'s finally body on this path.  The body
        executes with only the frames *outside* ``frame`` active."""
        saved = self.frames
        self.frames = saved[:upto]
        try:
            entry = self.cfg.add("finally", frame["node"])
            self._connect(preds, entry, label)
            out = self._seq(frame["final"], {entry})
        finally:
            self.frames = saved
        return out

    def _unwind(self, preds: Set[int], stop_at: Optional[dict]) -> Set[int]:
        """Run the finally bodies of every try frame inside ``stop_at``
        (exclusive; None = all frames), innermost first — the path a
        return/break/continue takes out of nested ``try`` statements."""
        for i in range(len(self.frames) - 1, -1, -1):
            f = self.frames[i]
            if f is stop_at:
                break
            if f["kind"] == "try" and f["final"]:
                preds = self._finally_copy(f, preds, upto=i)
        return preds

    # -- statements --------------------------------------------------------

    def build(self) -> CFG:
        out = self._seq(self.fn.body, {self.entry})
        self._connect(out, self.exit)
        return self.cfg

    def _seq(self, stmts: Sequence[ast.stmt], preds: Set[int]) -> Set[int]:
        for s in stmts:
            if not preds:
                break  # unreachable tail (after return/raise/...)
            preds = self._stmt(s, preds)
        return preds

    def _stmt(self, s: ast.stmt, preds: Set[int]) -> Set[int]:
        if isinstance(s, ast.If):
            return self._if(s, preds)
        if isinstance(s, (ast.While,)):
            return self._loop(s, preds, is_for=False)
        if isinstance(s, (ast.For, ast.AsyncFor)):
            return self._loop(s, preds, is_for=True)
        if isinstance(s, ast.Try):
            return self._try(s, preds)
        if isinstance(s, (ast.With, ast.AsyncWith)):
            return self._with(s, preds)
        if isinstance(s, ast.Return):
            n = self.cfg.add("stmt", s)
            self._connect(preds, n)
            out = self._unwind({n}, stop_at=None)
            self._connect(out, self.exit)
            return set()
        if isinstance(s, ast.Raise):
            n = self.cfg.add("stmt", s)
            self._connect(preds, n)
            self._exc_edges(n)
            return set()
        if isinstance(s, (ast.Break, ast.Continue)):
            n = self.cfg.add("stmt", s)
            self._connect(preds, n)
            loop = next((f for f in reversed(self.frames)
                         if f["kind"] == "loop"), None)
            out = self._unwind({n}, stop_at=loop)
            if loop is not None:
                if isinstance(s, ast.Break):
                    loop["breaks"] |= out
                else:
                    self._connect(out, loop["head"])
            else:  # syntactically invalid; treat as function exit
                self._connect(out, self.exit)
            return set()
        # Simple statement (incl. nested def/class: opaque single nodes).
        n = self.cfg.add("stmt", s)
        self._connect(preds, n)
        self._exc_edges_if_protected(n)
        return {n}

    def _exc_edges_if_protected(self, node: int) -> None:
        if any(f["kind"] == "try" and f.get("protecting")
               for f in self.frames):
            self._exc_edges(node)

    def _if(self, s: ast.If, preds: Set[int]) -> Set[int]:
        n = self.cfg.add("stmt", s)  # condition evaluation
        self._connect(preds, n)
        then_out = self._seq(s.body, {n})
        else_out = self._seq(s.orelse, {n}) if s.orelse else {n}
        return then_out | else_out

    def _loop(self, s, preds: Set[int], is_for: bool) -> Set[int]:
        head = self.cfg.add("loop-head", s)
        self._connect(preds, head)
        self._exc_edges_if_protected(head)
        frame = {"kind": "loop", "head": head, "breaks": set()}
        self.frames.append(frame)
        body_out = self._seq(s.body, {head})
        self.frames.pop()
        self._connect(body_out, head)  # back edge
        after: Set[int] = set()
        test = getattr(s, "test", None)
        infinite = (not is_for and isinstance(test, ast.Constant)
                    and bool(test.value))
        if not infinite:
            after = {head}
        if s.orelse:
            after = self._seq(s.orelse, after)
        return after | frame["breaks"]

    def _try(self, s: ast.Try, preds: Set[int]) -> Set[int]:
        handlers = [self.cfg.add("except", h) for h in s.handlers]
        frame = {"kind": "try", "node": s, "handlers": handlers,
                 "final": s.finalbody, "protecting": True}
        self.frames.append(frame)
        body_out = self._seq(s.body, preds)
        frame["protecting"] = False  # orelse/handlers are not protected
        if s.orelse:
            body_out = self._seq(s.orelse, body_out)
        handler_out: Set[int] = set()
        for h, entry in zip(s.handlers, handlers):
            handler_out |= self._seq(h.body, {entry})
        self.frames.pop()
        norm = body_out | handler_out
        if s.finalbody and norm:
            # Normal-completion instance of the finally body (the
            # exceptional instances are built per raise site/path).
            norm = self._seq(s.finalbody, norm)
        return norm

    def _with(self, s, preds: Set[int]) -> Set[int]:
        n = self.cfg.add("with", s)
        self._connect(preds, n)
        self._exc_edges_if_protected(n)
        body_out = self._seq(s.body, {n})
        x = self.cfg.add("with-exit", s)
        self._connect(body_out, x)
        return {x}


def build_cfg(fn: ast.AST) -> CFG:
    """CFG for one ``FunctionDef``/``AsyncFunctionDef`` (or any object
    with a ``body`` list of statements, e.g. an ``ast.Module``)."""
    return _Builder(fn).build()


# --------------------------------------------------------------------------
# acquire/release analysis
# --------------------------------------------------------------------------


@dataclass
class Resource:
    family: str            # "pin" | "lock" | "file" | "thread"
    key: Optional[str]     # canonical text of the pinned arg / receiver
    root: Optional[str]    # leading simple name of key (escape analysis)
    node: int              # CFG node of the acquire
    call: ast.Call         # for finding location/message
    bound: Optional[str] = None   # name bound to the acquire result
    label: str = ""        # human-readable acquire description


@dataclass
class Leak:
    resource: Resource
    #: "all-paths" (RT301: some plain path leaks) or "except-path"
    #: (RT304: only paths through an except handler leak).
    kind: str
    #: Handler line for except-path leaks (anchor for the message).
    handler_line: int = 0
    has_release: bool = False


def _node_exprs(node: Node) -> List[ast.AST]:
    """The expressions that actually execute *at* this CFG node.  A
    compound statement's AST (If/While/For) contains its whole body —
    only the condition/iterable part belongs to the node itself; the
    body statements are their own nodes."""
    s = node.stmt
    if s is None or node.kind in ("except", "finally"):
        return []
    if node.kind == "loop-head":
        if isinstance(s, (ast.For, ast.AsyncFor)):
            return [s.iter]
        return [s.test] if getattr(s, "test", None) is not None else []
    if node.kind in ("with", "with-exit"):
        return [item.context_expr for item in s.items]
    if isinstance(s, ast.If):
        return [s.test]
    return [s]


def _iter_calls(root: ast.AST) -> Iterator[ast.Call]:
    """Calls under an expression/statement — including ``root`` itself
    when it IS a call (an ``if f():`` condition) — not descending into
    nested function/class bodies (their execution is deferred; a
    release inside a callback does not release on this path)."""
    if isinstance(root, ast.Call):
        yield root
    stack: List[ast.AST] = [root]
    while stack:
        node = stack.pop()
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda, ast.ClassDef)):
                continue
            if isinstance(child, ast.Call):
                yield child
            stack.append(child)


def _node_calls(node: Node) -> Iterator[ast.Call]:
    for expr in _node_exprs(node):
        yield from _iter_calls(expr)


def _dotted(node: ast.AST) -> Optional[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _last_seg(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _root_name(node: ast.AST) -> Optional[str]:
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Call)):
        node = node.func if isinstance(node, ast.Call) else node.value
    return node.id if isinstance(node, ast.Name) else None


def _unparse(node: Optional[ast.AST]) -> str:
    if node is None:
        return ""
    try:
        return ast.unparse(node)
    except Exception:
        return "<expr>"


def _ctl_verb(call: ast.Call) -> Optional[str]:
    """``"pin_object"`` for ``_control("pin_object", ...)`` shapes."""
    if _last_seg(call.func) in _CTL_NAMES and call.args and \
            isinstance(call.args[0], ast.Constant) and \
            isinstance(call.args[0].value, str):
        return call.args[0].value
    return None


_LOCKISH = ("lock", "mutex", "sem")


def _find_acquires(cfg: CFG, thread_names: Set[str]) -> List[Resource]:
    """Acquire sites: only plain ``Assign``/``Expr`` statements qualify
    — an acquire inside a ``return``/condition escapes or feeds control
    flow in ways a per-function pass cannot judge fairly."""
    out: List[Resource] = []
    for n in cfg.nodes:
        if n.kind != "stmt" or \
                not isinstance(n.stmt, (ast.Assign, ast.Expr)):
            continue
        stmt = n.stmt
        bound: Optional[str] = None
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and \
                isinstance(stmt.targets[0], ast.Name):
            bound = stmt.targets[0].id
        for call in _iter_calls(stmt):
            res = _classify_acquire(call, n.idx, bound, stmt, thread_names)
            if res is not None:
                out.append(res)
    return out


def _classify_acquire(call: ast.Call, node: int, bound: Optional[str],
                      stmt: ast.AST,
                      thread_names: Set[str]) -> Optional[Resource]:
    seg = _last_seg(call.func)
    # -- pins ------------------------------------------------------------
    if seg in PAIRED_APIS:
        arg = call.args[0] if call.args else None
        key = _unparse(arg) if arg is not None else _dotted(call.func)
        return Resource("pin", key, _root_name(arg) if arg is not None
                        else None, node, call,
                        label=f"{seg}({key})")
    verb = _ctl_verb(call)
    if verb in _CTL_PAIRS:
        arg = call.args[1] if len(call.args) > 1 else None
        key = _unparse(arg)
        return Resource("pin", key, _root_name(arg) if arg is not None
                        else None, node, call,
                        label=f'_control("{verb}", {key})')
    # -- bare lock.acquire() --------------------------------------------
    if seg == "acquire" and isinstance(call.func, ast.Attribute):
        recv = _unparse(call.func.value)
        if any(t in recv.split(".")[-1].lower() for t in _LOCKISH):
            return Resource("lock", recv, _root_name(call.func.value),
                            node, call, bound=bound,
                            label=f"{recv}.acquire()")
    # -- open() outside with --------------------------------------------
    if _dotted(call.func) in ("open", "io.open"):
        # ``with open(...)`` settles by construction; only Assign/Expr
        # statement shapes reach here (With items produce "with" nodes).
        if isinstance(stmt, ast.Assign) and bound:
            return Resource("file", bound, bound, node, call, bound=bound,
                            label=f"{bound} = open(...)")
        if isinstance(stmt, ast.Expr) and stmt.value is call:
            return Resource("file", None, None, node, call,
                            label="open(...) result discarded")
    # -- thread start ----------------------------------------------------
    if seg == "start" and isinstance(call.func, ast.Attribute):
        recv = call.func.value
        if isinstance(recv, ast.Name) and recv.id in thread_names:
            return Resource("thread", recv.id, recv.id, node, call,
                            label=f"{recv.id}.start()")
        if isinstance(recv, ast.Call) and \
                (_dotted(recv.func) or "").endswith("threading.Thread"):
            return Resource("thread", None, None, node, call,
                            label="threading.Thread(...).start()")
    return None


def _local_thread_names(fn: ast.AST) -> Set[str]:
    """Local names assigned a bare ``threading.Thread(...)`` in this
    scope.  Threads stored into attributes/containers at construction
    have already escaped and are not tracked."""
    names: Set[str] = set()
    for stmt in ast.walk(fn):
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and \
                isinstance(stmt.targets[0], ast.Name) and \
                isinstance(stmt.value, ast.Call) and \
                (_dotted(stmt.value.func) or "").endswith(
                    "threading.Thread"):
            names.add(stmt.targets[0].id)
    return names


_RELEASE_ATTRS = {"lock": ("release",), "file": ("close",),
                  "thread": ("join",)}


def _node_settles(node: Node, res: Resource) -> Tuple[bool, bool]:
    """(settles, is_release): does executing this node settle the
    resource — paired release, or escape (stored / returned / passed
    on)?"""
    for call in _node_calls(node):
        if _is_release(call, res):
            return True, True
    root = res.root or res.bound
    if root is None:
        return False, False
    if node.kind == "stmt" and isinstance(node.stmt, ast.If) and \
            _mentions(node.stmt.test, root) and \
            _subtree_releases(node.stmt, res):
        # Guarded-cleanup idiom: `if fh is not None: fh.close()` — the
        # test on the handle itself acknowledges conditional ownership.
        return True, True
    if node.kind == "stmt" and node.stmt is not None and \
            _escapes(node, root, res):
        return True, False
    return False, False


def _subtree_releases(stmt: ast.AST, res: Resource) -> bool:
    for call in _iter_calls(stmt):
        if _is_release(call, res):
            return True
    return False


def _is_release(call: ast.Call, res: Resource) -> bool:
    seg = _last_seg(call.func)
    if res.family == "pin":
        releases = set()
        for acq, rels in PAIRED_APIS.items():
            releases |= set(rels)
        if seg in releases:
            if not call.args:
                return True
            return _unparse(call.args[0]) == res.key
        verb = _ctl_verb(call)
        if verb in _CTL_PAIRS.values():
            return len(call.args) < 2 or \
                _unparse(call.args[1]) == res.key
        return False
    if seg in _RELEASE_ATTRS.get(res.family, ()):
        if isinstance(call.func, ast.Attribute):
            return _unparse(call.func.value) == res.key
    return False


def _escapes(node: Node, root: str, res: Resource) -> bool:
    """The resource's root name stored into longer-lived state, passed
    to another callable, or returned/raised/yielded: ownership moved,
    the leak (if any) is no longer this function's."""
    stmt = node.stmt
    if isinstance(stmt, (ast.Return, ast.Raise)) and \
            _mentions_bare(stmt, root):
        return True
    if isinstance(stmt, ast.Assign) and \
            _mentions_bare(stmt.value, root) and \
            not (len(stmt.targets) == 1 and
                 isinstance(stmt.targets[0], ast.Name) and
                 stmt.targets[0].id == root):
        # The handle itself stored somewhere (attribute, container,
        # alias) — ownership moved.  A *bare* mention only: `fh.read()`
        # uses the handle without moving it.
        return True
    if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Yield):
        return True
    if res.family == "pin":
        # A pin's key is an *identifier* (object id), not the resource
        # handle — passing it to kv/log calls moves nothing; only
        # storing/returning it keeps a path to the later unpin.
        return False
    for call in _node_calls(node):
        if _classify_acquire(call, -1, None, stmt, set()) is not None:
            continue  # the acquire itself does not settle
        if _is_release(call, res):
            continue  # handled as release
        for arg in list(call.args) + [kw.value for kw in call.keywords]:
            if _mentions(arg, root):
                return True
    return False


def _mentions(node: ast.AST, name: str) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id == name and \
                isinstance(sub.ctx, ast.Load):
            return True
    return False


def _mentions_bare(node: ast.AST, name: str) -> bool:
    """A Load of ``name`` that is not merely the receiver of an
    attribute access: ``{"out": fh}`` moves the handle, ``fh.read()``
    only uses it."""
    receivers = {id(sub.value) for sub in ast.walk(node)
                 if isinstance(sub, ast.Attribute)}
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id == name and \
                isinstance(sub.ctx, ast.Load) and id(sub) not in receivers:
            return True
    return False


def _reachable(cfg: CFG, starts: Set[int], blocked: Set[int],
               skip_kinds: Set[str] = frozenset()) -> Set[int]:
    seen: Set[int] = set()
    stack = [s for s in starts if s not in blocked]
    while stack:
        n = stack.pop()
        if n in seen:
            continue
        if cfg.nodes[n].kind in skip_kinds:
            continue
        seen.add(n)
        for b in cfg.successors(n):
            if b not in blocked and b not in seen:
                stack.append(b)
    return seen


def analyze_function(fn: ast.AST) -> List[Leak]:
    """Leaks in one function: resources acquired but not settled on
    every CFG path to the exit (threads: on *any* path — a join that
    exists somewhere is enough)."""
    cfg = build_cfg(fn)
    thread_names = _local_thread_names(fn)
    leaks: List[Leak] = []
    for res in _find_acquires(cfg, thread_names):
        settle_nodes: Set[int] = set()
        release_nodes: Set[int] = set()
        for n in cfg.nodes:
            if n.idx == res.node:
                continue
            settles, is_rel = _node_settles(n, res)
            if settles:
                settle_nodes.add(n.idx)
                if is_rel:
                    release_nodes.add(n.idx)
        starts = {b for b, lab in cfg.succ[res.node] if lab == "normal"}
        if res.family == "thread":
            # ANY-path semantics, and registration may precede start()
            # (`bundle_threads.append(t); t.start()`): a join/escape
            # anywhere in the function is enough.
            if res.key is None or not settle_nodes:
                leaks.append(Leak(res, "all-paths"))
            continue
        reach = _reachable(cfg, starts, blocked=settle_nodes)
        if cfg.exit not in reach:
            continue  # settled on every path
        # Classify: does a leak path exist that avoids except handlers?
        reach_plain = _reachable(cfg, starts, blocked=settle_nodes,
                                 skip_kinds={"except"})
        if cfg.exit in reach_plain:
            leaks.append(Leak(res, "all-paths",
                              has_release=bool(release_nodes)))
        else:
            hline = 0
            for n in cfg.nodes:
                if n.kind == "except" and n.idx in reach:
                    hline = n.line
                    break
            leaks.append(Leak(res, "except-path", handler_line=hline,
                              has_release=bool(settle_nodes)))
    return leaks


def iter_function_leaks(tree: ast.AST) -> Iterator[Tuple[ast.AST, Leak]]:
    """(function, leak) pairs over every function in a module."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for leak in analyze_function(node):
                yield node, leak


# --------------------------------------------------------------------------
# lock-held-set analysis (RT4xx guarded-by inference)
# --------------------------------------------------------------------------
#
# Which locks are held at each CFG node of one function.  Two sources,
# unioned:
#
# * **Lexical** ``with self._lock:`` ranges.  The builder allocates the
#   "with" node, then every body node, then the matching "with-exit"
#   node, so body nodes occupy exactly the index interval between the
#   pair — including per-path ``finally`` copies instantiated for
#   returns inside the body.  Exception edges jump *out* of the
#   interval to handlers built outside it, which matches the runtime:
#   ``__exit__`` released the lock before the handler ran.
#
# * **Flow** for bare ``X.acquire()`` / ``X.release()`` pairs: a
#   forward must-hold dataflow (meet = intersection over predecessors),
#   so a lock counts as held at a node only when EVERY path reaching it
#   acquired and did not release.
#
# Lock names are canonical dotted receivers ("self._lock").  ``aliases``
# maps other receivers onto them — ``self._wake -> self._lock`` for
# ``self._wake = threading.Condition(self._lock)`` (entering the
# condition IS entering the lock).


class LockAnalysis:
    """Per-function lock-held-set machinery, built once per method and
    re-solved cheaply per entry assumption (the per-class fixpoint in
    rules_concurrency re-runs only the flow part)."""

    def __init__(self, fn: ast.AST, locks: Set[str],
                 aliases: Optional[Dict[str, str]] = None):
        self.fn = fn
        self.locks = frozenset(locks)
        self.aliases = dict(aliases or {})
        self.cfg = build_cfg(fn)
        self._lexical = self._lexical_ranges()
        self._gen, self._kill = self._gen_kill()
        self._preds: Dict[int, Set[int]] = {
            n.idx: set() for n in self.cfg.nodes}
        for a, dsts in self.cfg.succ.items():
            for b, _lab in dsts:
                self._preds[b].add(a)

    # -- lock name resolution ---------------------------------------------

    def resolve(self, expr: ast.AST) -> Optional[str]:
        """Canonical lock name for an expression, through aliases, or
        None when the expression is not one of this class's locks."""
        d = _dotted(expr)
        if d is None:
            return None
        d = self.aliases.get(d, d)
        return d if d in self.locks else None

    # -- lexical `with` ranges --------------------------------------------

    def _lexical_ranges(self) -> Dict[int, frozenset]:
        held: Dict[int, Set[str]] = {}
        opens: Dict[int, Tuple[int, frozenset]] = {}
        for n in self.cfg.nodes:
            if n.kind == "with":
                got = frozenset(
                    name for item in n.stmt.items
                    if (name := self.resolve(item.context_expr)))
                opens[n.idx] = (n.idx, got)
            elif n.kind == "with-exit":
                # Match the open with the same stmt (each With statement
                # produces exactly one with/with-exit pair).
                for widx, (start, got) in list(opens.items()):
                    if self.cfg.nodes[widx].stmt is n.stmt:
                        if got:
                            for i in range(start + 1, n.idx):
                                held.setdefault(i, set()).update(got)
                        del opens[widx]
                        break
        return {i: frozenset(s) for i, s in held.items()}

    # -- bare acquire/release gen/kill ------------------------------------

    def _gen_kill(self) -> Tuple[Dict[int, frozenset], Dict[int, frozenset]]:
        gen: Dict[int, frozenset] = {}
        kill: Dict[int, frozenset] = {}
        for n in self.cfg.nodes:
            g: Set[str] = set()
            k: Set[str] = set()
            for call in _node_calls(n):
                if not isinstance(call.func, ast.Attribute):
                    continue
                name = self.resolve(call.func.value)
                if name is None:
                    continue
                if call.func.attr == "acquire":
                    g.add(name)
                elif call.func.attr == "release":
                    k.add(name)
            if g:
                gen[n.idx] = frozenset(g)
            if k:
                kill[n.idx] = frozenset(k)
        return gen, kill

    # -- solving -----------------------------------------------------------

    def held_map(self, entry_held: frozenset = frozenset()
                 ) -> Dict[int, frozenset]:
        """node idx -> locks held when the node *executes*.  The entry
        assumption models the caller's locks (``_locked`` contract)."""
        entry_held = frozenset(entry_held) & self.locks
        flow = self._solve_flow(entry_held)
        return {n.idx: flow.get(n.idx, frozenset()) |
                self._lexical.get(n.idx, frozenset())
                for n in self.cfg.nodes}

    def _solve_flow(self, entry_held: frozenset) -> Dict[int, frozenset]:
        if not self._gen and not entry_held:
            return {}
        UNIV = self.locks
        inn: Dict[int, frozenset] = {self.cfg.entry: entry_held}
        work = [self.cfg.entry]
        while work:
            i = work.pop()
            cur = inn.get(i, UNIV)
            o = (cur - self._kill.get(i, frozenset())) | \
                self._gen.get(i, frozenset())
            for b, _lab in self.cfg.succ[i]:
                old = inn.get(b)
                new = o if old is None else (old & o)
                if old is None or new != old:
                    inn[b] = new
                    work.append(b)
        # Unreachable nodes (no computed IN) report the entry assumption:
        # dead code should not mint bare-access findings.
        return {n.idx: inn.get(n.idx, UNIV) for n in self.cfg.nodes}


def lock_held_map(fn: ast.AST, locks: Set[str],
                  aliases: Optional[Dict[str, str]] = None,
                  entry_held: frozenset = frozenset()
                  ) -> Tuple[CFG, Dict[int, frozenset]]:
    """One-shot convenience: (cfg, node idx -> held lock names)."""
    la = LockAnalysis(fn, locks, aliases)
    return la.cfg, la.held_map(entry_held)
