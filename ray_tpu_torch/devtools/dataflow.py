"""Per-function control-flow graph (the CFG of
ray_tpu/devtools/dataflow.py, copied whole; its acquire/release and lock
analyses serve the JAX package's control-plane rule families, which the
port does not carry).

* :func:`build_cfg` lowers one function body to a CFG of per-statement
  nodes with labelled edges: branches, loop back-edges, ``with``
  enter/exit markers, ``try``/``except``/``finally`` (exception edges
  from every statement in a protected body to its handlers, ``finally``
  blocks instantiated per exit path so a ``return`` inside ``try`` still
  runs them), and early ``return``/``raise``/``break``/``continue``.
* :func:`_node_exprs` / :func:`_node_calls`: what runs *at* one node.

The port's RT504 (``rules_torch``) walks the paths from a scratch call
over it.

Exception model: calls are assumed not to raise *except* inside a
``try`` body, where every statement gets an edge to the enclosing
handlers/``finally`` — the places where the code itself acknowledges
exceptions are exactly the places where cleanup bugs hide.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

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
