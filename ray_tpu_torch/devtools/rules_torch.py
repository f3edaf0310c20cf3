"""Eager-torch correctness & performance lint rules (RT5xx; counterpart of
ray_tpu/devtools/rules_jax.py).

The JAX family audits jit-compiled code; in eager PyTorch three of its
bug classes keep their meaning, each in torch's spelling:

* RT502 — implicit device→host sync per iteration: ``float()`` /
  ``int()`` / ``bool()`` / ``complex()`` / ``.item()`` / ``.tolist()`` /
  ``.numpy()`` / ``np.asarray()`` on a CUDA tensor inside a loop or
  comprehension — the spellings :mod:`ray_tpu_torch.devtools.syncdebug`
  patches at runtime.  One sync per *chunk* is the batched pattern (the
  engine's ``.cpu().numpy()`` once per decode chunk); one per element is
  the defect.
* RT504 — scratch-buffer read: an argument a call uses as scratch, read
  after the call without being rebound.  Today that is the gradients
  passed to ``AdamW.update`` (``ray_tpu_torch/optim.py``: the update
  applies the step in place and overwrites ``grads``, the port's form of
  ``donate_argnums``).  Reads are found over the per-function CFG
  (:mod:`ray_tpu_torch.devtools.dataflow`): a read on any path from the
  call that no rebind cuts off.
* RT505 — identical random streams: a ``torch.Generator`` (or the global
  generator) created or re-seeded with the same seed inside a loop, so
  each pass draws the same numbers; or two generators seeded alike
  feeding two samplers.  (A torch generator advances as it is used, so
  using one generator twice — JAX's "key reuse" — is not the bug.)

RT501 (traced control flow), RT503 (shape churn under jit) and RT506
(op-by-op dispatch outside jit) have no eager counterpart and are listed
as not carried (``lint.NOT_CARRIED``); runtime shape churn is what
``profiler.recompile`` counts.

Which values are CUDA tensors is read from the code, as JAX's rules read
device values from ``jnp`` calls: ``.cuda()``, ``.to(<device>)`` and
torch factories given ``device=<device>``, where ``<device>`` is a
``"cuda..."`` string, ``torch.device("cuda...")`` or a name ending in
``device``/``dev``/``cuda`` (the port's ``device`` arguments default to
the card), and whatever torch computes from such values.  ``.cpu()``,
``.numpy()``, ``.tolist()``, ``.item()`` and ``.to("cpu")`` results are
host values.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from . import dataflow
from .lint import (NOT_CARRIED, Finding, ModuleContext, Rule, dotted,
                   register, walk_same_scope)

# --------------------------------------------------------------------------
# Shared torch-context detection
# --------------------------------------------------------------------------

#: Attribute reads that copy nothing to the host: metadata a CUDA tensor
#: keeps on the host.
STATIC_ATTRS = frozenset({
    "shape", "dtype", "ndim", "device", "is_cuda", "requires_grad",
    "layout", "is_leaf", "names",
})

#: Builtins whose result on a tensor is host metadata.
_STATIC_CALLS = frozenset({"len", "isinstance", "type", "id", "getattr",
                           "hasattr"})

#: Tensor methods whose result is a host value (the explicit copies).
_HOST_METHODS = frozenset({"cpu", "numpy", "tolist", "item", "size",
                           "dim", "numel", "element_size", "data_ptr",
                           "stride", "get_device", "is_contiguous"})

#: Host-coercion spellings RT502 flags (and syncdebug patches at
#: runtime).
_COERCION_BUILTINS = frozenset({"float", "int", "bool", "complex"})
_COERCION_METHODS = frozenset({"item", "tolist", "numpy", "__array__"})

#: Calls that seed a generator: ``torch.manual_seed(s)``,
#: ``torch.cuda.manual_seed[_all](s)``, ``<gen>.manual_seed(s)``.
_SEEDERS = frozenset({"manual_seed", "manual_seed_all"})

#: Optimizer factories whose ``update(grads, ...)`` uses ``grads`` as
#: scratch (ray_tpu_torch/optim.py), and the scratch argument positions.
_SCRATCH_FACTORIES = frozenset({"adamw", "AdamW"})
_SCRATCH_ARGS: Tuple[int, ...] = (0,)
_SCRATCH_KWARGS = frozenset({"grads"})


class _TorchContext:
    """Per-module torch facts, computed once and cached on the
    ModuleContext (every RT5xx rule shares one instance)."""

    def __init__(self, ctx: ModuleContext):
        self.torch_names: Set[str] = set()   # names bound to torch
        self.torch_funcs: Set[str] = set()   # names imported from torch
        self.np_names: Set[str] = set()      # ... to (host) numpy
        for node in ctx.nodes(ast.Import):
            for alias in node.names:
                bound = alias.asname or alias.name.split(".")[0]
                if alias.name == "torch" or alias.name.startswith("torch."):
                    self.torch_names.add(bound)
                elif alias.name == "numpy":
                    self.np_names.add(bound)
        for node in ctx.nodes(ast.ImportFrom):
            if node.module and (node.module == "torch"
                                or node.module.startswith("torch.")):
                for alias in node.names:
                    self.torch_funcs.add(alias.asname or alias.name)
        self.uses_torch = bool(self.torch_names or self.torch_funcs)

    def is_torch_call(self, call: ast.Call) -> bool:
        name = dotted(call.func) or ""
        return name.split(".", 1)[0] in self.torch_names or \
            name in self.torch_funcs

    def is_device_call(self, call: ast.Call) -> bool:
        """Does this call put a tensor on the card?  ``x.cuda()``,
        ``x.to(<device>)`` and torch calls given ``device=<device>``."""
        func = call.func
        if isinstance(func, ast.Attribute) and func.attr == "cuda" and \
                not (dotted(func) or "").startswith(
                    tuple(f"{t}." for t in self.torch_names)):
            return True
        dev = next((kw.value for kw in call.keywords if kw.arg == "device"),
                   None)
        if isinstance(func, ast.Attribute) and func.attr == "to" and \
                dev is None and call.args:
            dev = call.args[0]
        if dev is None:
            return False
        if isinstance(func, ast.Attribute) and func.attr == "to":
            return _is_card(dev)
        return self.is_torch_call(call) and _is_card(dev)


def _is_card(expr: ast.AST) -> bool:
    """May ``expr`` name a CUDA device?"""
    if isinstance(expr, ast.Constant):
        return isinstance(expr.value, str) and expr.value.startswith("cuda")
    if isinstance(expr, ast.Call) and expr.args and \
            (dotted(expr.func) or "").endswith("device"):
        return _is_card(expr.args[0])
    name = dotted(expr)
    if name is None:
        return False
    last = name.rsplit(".", 1)[-1].lower()
    return last.endswith(("device", "cuda")) or last == "dev"


def torch_context(ctx: ModuleContext) -> _TorchContext:
    cached = getattr(ctx, "_rt5_torch", None)
    if cached is None:
        cached = ctx._rt5_torch = _TorchContext(ctx)
    return cached


def _assigned_names(target: ast.AST) -> List[str]:
    if isinstance(target, (ast.Tuple, ast.List)):
        out: List[str] = []
        for el in target.elts:
            out.extend(_assigned_names(el))
        return out
    if isinstance(target, ast.Starred):
        return _assigned_names(target.value)
    name = dotted(target)
    return [name] if name else []


def _loops_in(fn: ast.AST) -> List[ast.AST]:
    return [n for n in walk_same_scope(fn)
            if isinstance(n, (ast.For, ast.While))]


# --------------------------------------------------------------------------
# RT502: host coercion of a CUDA tensor per iteration
# --------------------------------------------------------------------------


class _HotScan:
    """One ordered walk of a function body (JAX's ``_HotScan``): which
    names hold CUDA tensors, and host coercions at loop depth >= 1."""

    def __init__(self, rule: Rule, ctx: ModuleContext, tc: _TorchContext,
                 fn: ast.AST):
        self.rule = rule
        self.ctx = ctx
        self.tc = tc
        self.fn = fn
        self.device: Set[str] = set()
        self.findings: List[Finding] = []

    def run(self) -> List[Finding]:
        for stmt in self.fn.body:
            self._stmt(stmt, 0)
        return self.findings

    # -- traversal ---------------------------------------------------------

    def _stmt(self, s: ast.AST, depth: int) -> None:
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            return
        if isinstance(s, (ast.For, ast.AsyncFor)):
            self._expr(s.iter, depth)
            names = _assigned_names(s.target)
            if self._tainted(s.iter):
                self.device.update(names)
            else:
                self.device.difference_update(names)
            for child in s.body + s.orelse:
                self._stmt(child, depth + 1)
            return
        if isinstance(s, ast.While):
            self._expr(s.test, depth)
            for child in s.body + s.orelse:
                self._stmt(child, depth + 1)
            return
        if isinstance(s, ast.If):
            self._expr(s.test, depth)
            for child in s.body + s.orelse:
                self._stmt(child, depth)
            return
        if isinstance(s, ast.Try):
            for child in s.body + s.orelse + s.finalbody:
                self._stmt(child, depth)
            for handler in s.handlers:
                for hs in handler.body:
                    self._stmt(hs, depth)
            return
        if isinstance(s, (ast.With, ast.AsyncWith)):
            for item in s.items:
                self._expr(item.context_expr, depth)
            for child in s.body:
                self._stmt(child, depth)
            return
        if isinstance(s, (ast.Assign, ast.AnnAssign)):
            if s.value is None:
                return
            self._expr(s.value, depth)
            is_dev = self._tainted(s.value)
            targets = s.targets if isinstance(s, ast.Assign) else [s.target]
            for t in targets:
                for name in _assigned_names(t):
                    (self.device.add if is_dev
                     else self.device.discard)(name)
            return
        if isinstance(s, ast.AugAssign):
            self._expr(s.value, depth)
            if self._tainted(s.value):
                self.device.update(_assigned_names(s.target))
            return
        for child in ast.iter_child_nodes(s):
            if isinstance(child, ast.expr):
                self._expr(child, depth)

    def _expr(self, e: Optional[ast.AST], depth: int) -> None:
        if e is None:
            return
        if isinstance(e, (ast.ListComp, ast.SetComp, ast.DictComp,
                          ast.GeneratorExp)):
            inner = set()
            for gen in e.generators:
                self._expr(gen.iter, depth)
                if self._tainted(gen.iter):
                    inner.update(_assigned_names(gen.target))
            saved = set(self.device)
            self.device |= inner
            body = [e.key, e.value] if isinstance(e, ast.DictComp) \
                else [e.elt]
            for b in body:
                self._expr(b, depth + 1)
            for gen in e.generators:
                for cond in gen.ifs:
                    self._expr(cond, depth + 1)
            self.device = saved
            return
        if isinstance(e, ast.Lambda):
            return
        if isinstance(e, ast.Call):
            self._check_coercion(e, depth)
            for a in e.args:
                self._expr(a, depth)
            for kw in e.keywords:
                self._expr(kw.value, depth)
            if isinstance(e.func, ast.Attribute):
                self._expr(e.func.value, depth)
            return
        for child in ast.iter_child_nodes(e):
            if isinstance(child, ast.expr):
                self._expr(child, depth)

    # -- classification ----------------------------------------------------

    def _tainted(self, e: Optional[ast.AST]) -> bool:
        if e is None:
            return False
        if isinstance(e, ast.Call) and self.tc.is_device_call(e):
            return True
        if isinstance(e, ast.Attribute) and e.attr in STATIC_ATTRS:
            return False
        if isinstance(e, ast.Call):
            fname = dotted(e.func) or ""
            if fname in _STATIC_CALLS:
                return False
            if isinstance(e.func, ast.Attribute):
                attr = e.func.attr
                if attr in _HOST_METHODS:
                    return False       # the explicit host copy
                if attr == "to" and e.args and \
                        isinstance(e.args[0], ast.Constant) and \
                        e.args[0].value == "cpu":
                    return False
            if fname.split(".", 1)[0] in self.tc.np_names:
                return False           # a numpy result is on the host
            args = list(e.args) + [kw.value for kw in e.keywords]
            if isinstance(e.func, ast.Attribute):
                args.append(e.func.value)
            return any(self._tainted(a) for a in args)
        name = dotted(e)
        if name is not None:
            return name in self.device
        return any(self._tainted(c) for c in ast.iter_child_nodes(e)
                   if isinstance(c, ast.expr))

    def _check_coercion(self, call: ast.Call, depth: int) -> None:
        if depth < 1:
            return
        fname = dotted(call.func) or ""
        what: Optional[str] = None
        if fname in _COERCION_BUILTINS and len(call.args) == 1 and \
                self._tainted(call.args[0]):
            what = f"{fname}()"
        elif isinstance(call.func, ast.Attribute):
            attr = call.func.attr
            if attr in _COERCION_METHODS and \
                    self._tainted(call.func.value):
                what = f".{attr}()"
            elif attr in ("asarray", "array") and call.args and \
                    fname.split(".", 1)[0] in self.tc.np_names and \
                    self._tainted(call.args[0]):
                what = f"{fname}()"
        if what is None:
            return
        self.findings.append(self.ctx.finding(
            self.rule, call,
            f"implicit device→host sync per iteration: {what} on a CUDA "
            f"tensor inside a loop blocks on the card every pass — stack "
            f"on the card and copy ONCE outside the loop (one .cpu() of "
            f"the stacked result)"))


@register
class HostSyncInHotLoop(Rule):
    id = "RT502"
    summary = "implicit CUDA device→host sync per loop iteration"
    rationale = ("float()/int()/bool()/.item()/.tolist()/.numpy()/"
                 "np.asarray() on a CUDA tensor blocks the host thread "
                 "until the card catches up and the value lands.  Once "
                 "per chunk is the batched pattern; once per ELEMENT or "
                 "per iteration turns queued kernels into a sync storm "
                 "with the card idle between them — the class the "
                 "RAY_TPU_SYNC_DEBUG=1 tripwire counts at runtime.  "
                 "Stack on the card, copy once.")
    example_bad = (
        "losses = [model(b) for b in batches]   # CUDA scalars\n"
        "return [l.item() for l in losses]     # N syncs\n")
    example_good = (
        "losses = torch.stack([model(b) for b in batches])\n"
        "return losses.cpu().tolist()          # ONE sync\n")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        tc = torch_context(ctx)
        if not tc.uses_torch:
            return
        for fn in ctx.nodes(ast.FunctionDef, ast.AsyncFunctionDef):
            yield from _HotScan(self, ctx, tc, fn).run()


# --------------------------------------------------------------------------
# RT504: a read of a buffer after a call that used it as scratch
# --------------------------------------------------------------------------


def _scratch_bindings(ctx: ModuleContext) -> Set[str]:
    """Names (``opt``, ``self.opt``) bound to an optimizer whose
    ``update`` uses its gradients as scratch."""
    out: Set[str] = set()
    for node in ctx.nodes(ast.Assign, ast.AnnAssign):
        value = node.value
        if not isinstance(value, ast.Call):
            continue
        if (dotted(value.func) or "").rsplit(".", 1)[-1] not in \
                _SCRATCH_FACTORIES:
            continue
        targets = node.targets if isinstance(node, ast.Assign) \
            else [node.target]
        for t in targets:
            out.update(_assigned_names(t))
    return out


def _node_assigns(node: dataflow.Node) -> Set[str]:
    s = node.stmt
    if node.kind == "loop-head" and isinstance(s, (ast.For, ast.AsyncFor)):
        return set(_assigned_names(s.target))
    if node.kind != "stmt":
        return set()
    if isinstance(s, ast.Assign):
        return {n for t in s.targets for n in _assigned_names(t)}
    if isinstance(s, (ast.AnnAssign, ast.AugAssign)):
        return set(_assigned_names(s.target))
    return set()


def _reads(node: dataflow.Node, name: str) -> Optional[ast.AST]:
    """The first load of ``name`` among the expressions run at ``node``
    (an assignment's right-hand side runs before its target is bound)."""
    for expr in dataflow._node_exprs(node):
        roots = [expr.value] if isinstance(
            expr, (ast.Assign, ast.AnnAssign, ast.AugAssign)) and \
            expr.value is not None else [expr]
        if isinstance(expr, ast.AugAssign):
            roots.append(expr.target)
        for root in roots:
            for sub in ast.walk(root):
                if isinstance(sub, (ast.Name, ast.Attribute)) and \
                        isinstance(getattr(sub, "ctx", None), ast.Load) \
                        and dotted(sub) == name:
                    return sub
    return None


@register
class ScratchBufferRead(Rule):
    id = "RT504"
    dataflow = True
    summary = "buffer read after a call that used it as scratch"
    rationale = ("AdamW.update (ray_tpu_torch/optim.py) applies the step "
                 "to the params in place and overwrites the gradients it "
                 "is given as scratch — the port's form of "
                 "donate_argnums, so params, grads and the moments never "
                 "exist twice.  After the call the gradient tensors hold "
                 "sqrt(nu_hat) + eps, not gradients: a grad-norm or a "
                 "logged gradient read there is silently wrong.  Read "
                 "what you need before the update, or rebind the name.")
    example_bad = (
        "opt = adamw(1e-3)\n"
        "state = opt.update(grads, state, params)\n"
        "log(global_norm(grads))     # grads were overwritten\n")
    example_good = (
        "opt = adamw(1e-3)\n"
        "norm = global_norm(grads)   # before the update\n"
        "state = opt.update(grads, state, params)\n"
        "log(norm)\n")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        # The binding to adamw is the evidence; no torch import needed.
        bindings = _scratch_bindings(ctx)
        if not bindings:
            return
        for fn in ctx.nodes(ast.FunctionDef, ast.AsyncFunctionDef):
            yield from self._check_fn(ctx, fn, bindings)

    def _check_fn(self, ctx: ModuleContext, fn: ast.AST,
                  bindings: Set[str]) -> Iterator[Finding]:
        calls = [n for n in walk_same_scope(fn)
                 if isinstance(n, ast.Call) and
                 isinstance(n.func, ast.Attribute) and
                 n.func.attr == "update" and
                 dotted(n.func.value) in bindings]
        if not calls:
            return
        cfg = dataflow.build_cfg(fn)
        for node in cfg.nodes:
            for call in dataflow._node_calls(node):
                if call not in calls:
                    continue
                scratch = [dotted(call.args[i]) for i in _SCRATCH_ARGS
                           if i < len(call.args)]
                scratch += [dotted(kw.value) for kw in call.keywords
                            if kw.arg in _SCRATCH_KWARGS]
                for name in dict.fromkeys(n for n in scratch if n):
                    hit = self._first_read(cfg, node.idx, name)
                    if hit is None:
                        continue
                    yield ctx.finding(
                        self, hit,
                        f"{name!r} read after "
                        f"{dotted(call.func)} (line {call.lineno}) used "
                        f"it as scratch: the update overwrote it in "
                        f"place — read it before the update, or rebind "
                        f"{name!r}", anchors=(call,))

    @staticmethod
    def _first_read(cfg, start: int, name: str) -> Optional[ast.AST]:
        seen: Set[int] = set()
        stack = list(cfg.successors(start))
        while stack:
            idx = stack.pop()
            if idx in seen:
                continue
            seen.add(idx)
            node = cfg.nodes[idx]
            hit = _reads(node, name)
            if hit is not None:
                return hit
            if name in _node_assigns(node):
                continue               # rebound: the path is clean
            stack.extend(cfg.successors(idx))
        return None


# --------------------------------------------------------------------------
# RT505: identical random streams
# --------------------------------------------------------------------------


def _seed_of(call: ast.Call) -> Optional[ast.AST]:
    """The seed expression of a seeding call, or None."""
    func = call.func
    if isinstance(func, ast.Attribute) and func.attr in _SEEDERS and \
            call.args:
        return call.args[0]
    return None


def _invariant(expr: ast.AST, assigned: Set[str]) -> bool:
    """Does ``expr`` give the same value every pass of a loop that
    assigns ``assigned``?  Constants and names the loop never rebinds,
    with no call in between (a call may draw a fresh value)."""
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Call):
            return False
        if isinstance(sub, (ast.Name, ast.Attribute)):
            name = dotted(sub)
            if name is None or name in assigned or \
                    name.split(".", 1)[0] in assigned:
                return False
    return True


def _loop_assigned(loop: ast.AST) -> Set[str]:
    out: Set[str] = set()
    if isinstance(loop, (ast.For, ast.AsyncFor)):
        out.update(_assigned_names(loop.target))
    for node in walk_same_scope(loop):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                out.update(_assigned_names(t))
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            out.update(_assigned_names(node.target))
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            out.update(_assigned_names(node.target))
        elif isinstance(node, ast.NamedExpr):
            out.update(_assigned_names(node.target))
    return out


@register
class IdenticalRandomStreams(Rule):
    id = "RT505"
    summary = "generator seeded alike: identical random streams"
    rationale = ("A torch.Generator advances as it is used, so drawing "
                 "from one generator twice is fine; the bug is SEEDING "
                 "alike.  A generator created or re-seeded with the same "
                 "seed inside a loop replays the same numbers every pass "
                 "(identical dropout masks, identical exploration noise), "
                 "and two generators given the same seed feed two "
                 "samplers the same stream.  Seed once outside the loop, "
                 "or derive each seed (base + rank, base + step).")
    example_bad = (
        "for step in range(n):\n"
        "    g = torch.Generator(device='cuda').manual_seed(0)\n"
        "    noise = torch.randn(shape, generator=g)   # same every step\n")
    example_good = (
        "g = torch.Generator(device='cuda').manual_seed(0)\n"
        "for step in range(n):\n"
        "    noise = torch.randn(shape, generator=g)   # advances\n")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if not torch_context(ctx).uses_torch:
            return
        for fn in ctx.nodes(ast.FunctionDef, ast.AsyncFunctionDef):
            yield from self._in_loops(ctx, fn)
            yield from self._alike(ctx, fn)

    def _in_loops(self, ctx: ModuleContext,
                  fn: ast.AST) -> Iterator[Finding]:
        flagged: Set[int] = set()
        for loop in _loops_in(fn):
            assigned = _loop_assigned(loop)
            for node in walk_same_scope(loop):
                if not isinstance(node, ast.Call) or id(node) in flagged:
                    continue
                seed = _seed_of(node)
                if seed is None or not _invariant(seed, assigned):
                    continue
                flagged.add(id(node))
                yield ctx.finding(
                    self, node,
                    f"generator seeded with {ast.unparse(seed)} every "
                    f"iteration of the loop at line {loop.lineno}: each "
                    f"pass draws the SAME numbers — seed once outside "
                    f"the loop, or derive the seed from the iteration")

    def _alike(self, ctx: ModuleContext, fn: ast.AST) -> Iterator[Finding]:
        seeds: Dict[str, Tuple[str, ast.AST]] = {}   # generator -> seed
        for node in walk_same_scope(fn):
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call):
                seed = _seed_of(node.value)
                if seed is not None and isinstance(seed, ast.Constant):
                    for t in node.targets:
                        for name in _assigned_names(t):
                            seeds[name] = (repr(seed.value), node)
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute):
                seed = _seed_of(node)
                target = dotted(node.func.value)
                if seed is not None and isinstance(seed, ast.Constant) \
                        and target and not target.endswith(
                            ("torch", "cuda")):
                    seeds[target] = (repr(seed.value), node)
        if len(seeds) < 2:
            return
        fed = [dotted(kw.value) for node in walk_same_scope(fn)
               if isinstance(node, ast.Call)
               for kw in node.keywords if kw.arg == "generator"]
        used = sorted((g for g in dict.fromkeys(fed) if g in seeds),
                      key=lambda g: seeds[g][1].lineno)
        first_by_seed: Dict[str, str] = {}
        for g in used:
            seed, node = seeds[g]
            other = first_by_seed.setdefault(seed, g)
            if other != g:
                yield ctx.finding(
                    self, node,
                    f"generators {other!r} and {g!r} are both seeded "
                    f"with {seed} and both feed samplers: they draw the "
                    f"SAME stream — give each its own seed")


NOT_CARRIED.update({
    "RT501": ("Python control flow on a traced value inside jit",
              "not carried: eager torch traces nothing — an `if` on a "
              "tensor runs (and syncs: see RT502)."),
    "RT503": ("shape-unstable jit call site in a loop",
              "not carried: eager torch compiles nothing per shape; "
              "runtime shape churn (kernel builds and first launches of "
              "new launch shapes) is what profiler.recompile counts."),
    "RT506": ("per-iteration op-by-op jnp dispatch outside jit",
              "not carried: eager torch dispatches op by op by design; "
              "there is no jit to move the loop into."),
})
