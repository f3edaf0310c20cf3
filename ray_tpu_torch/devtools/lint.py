"""AST rule engine behind ``python -m ray_tpu_torch.devtools.lint`` (a
copy of ray_tpu/devtools/lint.py carrying the port's rule family).

The engine is deliberately small: a rule is an object with an ``id`` and
a ``check(ctx)`` generator over one parsed module, run over every linted
file.  Rules
self-register at import (``rules_torch`` at the bottom of this file — the
JAX package's control-plane families RT1xx-RT4xx are not carried), findings
are suppressible per line with ``# ray-tpu: noqa[RT502]`` (or a bare
``# ray-tpu: noqa`` for all rules), and output is text, JSON or GitHub
annotations.

Command line (mirrors the JAX package's ``ray-tpu lint`` for this
family)::

    python -m ray_tpu_torch.devtools.lint <paths> [--format json|github]
    python -m ray_tpu_torch.devtools.lint --list-rules
    python -m ray_tpu_torch.devtools.lint --explain RT502
    python -m ray_tpu_torch.devtools.lint --sync-report <file>

It exits 1 when findings remain, 2 when a report cannot be read.
"""

from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

_NOQA_RE = re.compile(
    r"#\s*ray-tpu:\s*noqa(?:\[(?P<rules>[A-Za-z0-9_,\s]+)\])?")


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str
    #: Additional lines where a ``# ray-tpu: noqa`` suppresses this
    #: finding (e.g. the ``with`` statement owning a blocking call).
    anchor_lines: Tuple[int, ...] = ()

    def to_dict(self) -> Dict[str, object]:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message}

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} " \
               f"{self.message}"


@dataclass
class LintResult:
    findings: List[Finding]
    files_checked: int
    #: rule id -> number of findings silenced by ``# ray-tpu: noqa``
    #: comments.  Reported (not hidden) so the suppression debt stays
    #: visible in every lint run.
    suppressed: Dict[str, int] = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.suppressed is None:
            self.suppressed = {}

    @property
    def ok(self) -> bool:
        return not self.findings


class ModuleContext:
    """One parsed module handed to every rule."""

    def __init__(self, tree: ast.Module, source: str, path: str):
        self.tree = tree
        self.source = source
        self.lines = source.splitlines()
        self.path = path
        self._by_type: Optional[Dict[type, List[ast.AST]]] = None

    def nodes(self, *types: type) -> List[ast.AST]:
        """All nodes of the given AST types, from ONE shared full-tree
        walk (rules iterating ast.walk() independently dominated lint
        wall time; the index makes each rule a dict lookup)."""
        if self._by_type is None:
            by_type: Dict[type, List[ast.AST]] = {}
            for node in ast.walk(self.tree):
                by_type.setdefault(type(node), []).append(node)
            self._by_type = by_type
        out: List[ast.AST] = []
        for t in types:
            out.extend(self._by_type.get(t, ()))
        return out

    def finding(self, rule: "Rule", node: ast.AST, message: str,
                anchors: Sequence[ast.AST] = ()) -> Finding:
        return Finding(rule.id, self.path, getattr(node, "lineno", 1),
                       getattr(node, "col_offset", 0) + 1, message,
                       tuple(getattr(a, "lineno", 1) for a in anchors))


class Rule:
    """Base class; subclasses set the metadata and implement check()."""

    id: str = "RT000"
    summary: str = ""
    rationale: str = ""
    #: True for rules that run over the per-function CFG
    #: (devtools/dataflow.py) rather than single AST nodes.
    dataflow: bool = False
    #: Optional snippets for ``ray-tpu lint --explain RULE``.
    example_bad: str = ""
    example_good: str = ""

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        raise NotImplementedError


_RULES: List[Rule] = []


def register(cls):
    _RULES.append(cls())
    return cls


def iter_rules() -> List[Rule]:
    return list(_RULES)


# -- shared AST helpers (used by the rule modules) --------------------------


def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def walk_same_scope(node: ast.AST) -> Iterator[ast.AST]:
    """Walk ``node`` without descending into nested function/class
    bodies (code that does not execute in the enclosing scope)."""
    stack: List[ast.AST] = list(ast.iter_child_nodes(node))
    while stack:
        child = stack.pop()
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda, ast.ClassDef)):
            continue
        yield child
        stack.extend(ast.iter_child_nodes(child))


# -- noqa suppression -------------------------------------------------------


def _noqa_map(source: str) -> Dict[int, Optional[Set[str]]]:
    """line -> suppressed rule ids (None = all rules)."""
    out: Dict[int, Optional[Set[str]]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        if "ray-tpu" not in line:
            continue
        m = _NOQA_RE.search(line)
        if not m:
            continue
        rules = m.group("rules")
        if rules is None:
            out[i] = None
        else:
            ids = {r.strip().upper() for r in rules.split(",") if r.strip()}
            prev = out.get(i, set())
            out[i] = None if prev is None else (prev or set()) | ids
    return out


def _suppressed(f: Finding, noqa: Dict[int, Optional[Set[str]]]) -> bool:
    for line in (f.line,) + f.anchor_lines:
        if line in noqa:
            allowed = noqa[line]
            if allowed is None or f.rule in allowed:
                return True
    return False


# -- running ----------------------------------------------------------------


def lint_source(source: str, path: str = "<snippet>",
                rules: Optional[Sequence[Rule]] = None,
                suppressed_counts: Optional[Dict[str, int]] = None,
                ) -> List[Finding]:
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding("RT001", path, e.lineno or 1, (e.offset or 0) + 1,
                        f"syntax error: {e.msg}")]
    ctx = ModuleContext(tree, source, path)
    noqa = _noqa_map(source)
    out: List[Finding] = []
    for rule in (rules if rules is not None else _RULES):
        for f in rule.check(ctx):
            if not _suppressed(f, noqa):
                out.append(f)
            elif suppressed_counts is not None:
                suppressed_counts[f.rule] = \
                    suppressed_counts.get(f.rule, 0) + 1
    out.sort(key=lambda f: (f.path, f.line, f.rule))
    return out


def iter_python_files(paths: Sequence[str]) -> Iterator[str]:
    for p in paths:
        if os.path.isfile(p):
            yield p
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(d for d in dirs
                             if d != "__pycache__" and not d.startswith("."))
            for fname in sorted(files):
                if fname.endswith(".py"):
                    yield os.path.join(root, fname)


def changed_python_files(base: str = "HEAD",
                         repo_root: Optional[str] = None) -> List[str]:
    """Python files modified per ``git diff <base>`` plus untracked ones
    — the ``--changed`` pre-commit set.  Raises
    RuntimeError when git fails (not a repo, unknown ref): a broken
    diff must be loud, never an empty green run."""
    import subprocess
    root = os.path.abspath(repo_root or os.getcwd())
    def _git(*args: str) -> List[str]:
        proc = subprocess.run(["git", *args], cwd=root,
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                proc.stderr.strip() or f"git {' '.join(args)} failed")
        return proc.stdout.splitlines()
    top = _git("rev-parse", "--show-toplevel")[0]
    names = _git("diff", "--name-only", "--diff-filter=d", base, "--")
    names += _git("ls-files", "--others", "--exclude-standard")
    out: List[str] = []
    for name in names:
        if not name.endswith(".py"):
            continue
        path = os.path.join(top, name)
        if os.path.exists(path) and path not in out:
            out.append(path)
    return sorted(out)


def lint_paths(paths: Sequence[str],
               rules: Optional[Sequence[Rule]] = None) -> LintResult:
    """Lint files/directories."""
    findings: List[Finding] = []
    suppressed: Dict[str, int] = {}
    n = 0
    # A missing input is a loud error, never a green no-op: a typo'd CI
    # path must not turn the lint gate into `0 findings in 0 files`.
    for p in paths:
        if not os.path.exists(p):
            findings.append(Finding("RT002", p, 1, 1,
                                    "no such file or directory"))
    for fpath in iter_python_files(paths):
        n += 1
        try:
            with open(fpath, encoding="utf-8", errors="replace") as f:
                source = f.read()
        except OSError as e:
            findings.append(Finding("RT002", fpath, 1, 1,
                                    f"unreadable file: {e}"))
            continue
        findings.extend(lint_source(source, fpath, rules=rules,
                                    suppressed_counts=suppressed))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return LintResult(findings, n, suppressed)


# -- output -----------------------------------------------------------------


def format_text(result: LintResult) -> str:
    lines = [f.render() for f in result.findings]
    tail = f"{len(result.findings)} finding(s) in " \
           f"{result.files_checked} file(s)"
    if result.suppressed:
        per = ", ".join(f"{rid}×{n}" for rid, n in
                        sorted(result.suppressed.items()))
        tail += f"; {sum(result.suppressed.values())} suppressed ({per})"
    lines.append(tail)
    return "\n".join(lines)


def format_json(result: LintResult) -> str:
    summaries = {r.id: r.summary for r in _RULES}
    return json.dumps({
        "version": 1,
        "files_checked": result.files_checked,
        "suppressed": dict(sorted(result.suppressed.items())),
        "findings": [dict(f.to_dict(),
                          explain=summaries.get(f.rule, ""))
                     for f in result.findings],
    }, indent=1)


def _gh_escape(text: str) -> str:
    """GitHub workflow-command property/data escaping."""
    return text.replace("%", "%25").replace("\r", "%0D").replace("\n",
                                                                 "%0A")


def format_github(result: LintResult) -> str:
    """GitHub annotations (`::error file=...`) — one line per finding,
    so a CI step surfaces findings inline on the PR diff."""
    lines = []
    for f in result.findings:
        lines.append(
            f"::error file={_gh_escape(f.path)},line={f.line},"
            f"col={f.col},title={f.rule}::"
            f"{_gh_escape(f.rule + ' ' + f.message)}")
    return "\n".join(lines)


#: The JAX package's RT5xx rules with no eager-torch meaning: id ->
#: (its summary there, why the port does not carry it).
NOT_CARRIED: Dict[str, Tuple[str, str]] = {}


def rule_catalog_text() -> str:
    lines = []
    for rule in _RULES:
        tags = "dataflow" if rule.dataflow else "ast"
        lines.append(f"{rule.id} [{tags}] {rule.summary}")
        if rule.rationale:
            lines.append(f"    {rule.rationale}")
    for rid, (summary, why) in sorted(NOT_CARRIED.items()):
        lines.append(f"{rid} [not carried] {summary}")
        lines.append(f"    {why}")
    return "\n".join(lines)


def explain_text(rule_id: str) -> Optional[str]:
    """Human explanation of one rule for ``--explain``:
    summary, rationale, bad/good example (when recorded) and the
    suppression syntax.  None for an unknown rule id."""
    rid = rule_id.strip().upper()
    rule = next((r for r in _RULES if r.id == rid), None)
    if rule is None:
        return None
    tags = "dataflow-backed" if rule.dataflow else "ast"
    lines = [f"{rule.id} [{tags}] — {rule.summary}", ""]
    if rule.rationale:
        lines += [rule.rationale, ""]
    if rule.example_bad:
        lines.append("Bad:")
        lines += ["    " + ln for ln in rule.example_bad.rstrip().
                  splitlines()]
        lines.append("")
    if rule.example_good:
        lines.append("Good:")
        lines += ["    " + ln for ln in rule.example_good.rstrip().
                  splitlines()]
        lines.append("")
    lines.append(f"Suppress a deliberate violation on its line with "
                 f"`# ray-tpu: noqa[{rule.id}]` "
                 f"(bare `# ray-tpu: noqa` suppresses every rule).")
    return "\n".join(lines)


# Rule modules self-register on import; they import helpers from this
# module, so this must stay at the bottom.
from . import rules_torch  # noqa: E402,F401


def main(argv: Optional[Sequence[str]] = None) -> int:
    """The command line (see the module docstring)."""
    import argparse
    import sys
    # Run as ``python -m``, this file is ``__main__``; the rules registered
    # themselves in the package's module of the same source.
    from ray_tpu_torch.devtools import lint as mod
    ap = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.devtools.lint",
        description="Eager-torch correctness and performance lint "
                    "(RT502, RT504, RT505).")
    ap.add_argument("paths", nargs="*")
    ap.add_argument("--format", dest="fmt", default="text",
                    choices=("text", "json", "github"))
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--explain", dest="explain_rule", default=None)
    ap.add_argument("--changed", action="store_true")
    ap.add_argument("--base", default="HEAD")
    ap.add_argument("--sync-report", dest="sync_report", default=None,
                    metavar="FILE",
                    help="Print the hottest implicit host-sync sites from "
                         "a syncdebug.report() saved as JSON, then exit.")
    args = ap.parse_args(argv)
    if args.list_rules:
        print(mod.rule_catalog_text())
        return 0
    if args.explain_rule is not None:
        text = mod.explain_text(args.explain_rule)
        if text is None:
            print(f"unknown rule {args.explain_rule!r} (see --list-rules)")
            return 1
        print(text)
        return 0
    if args.sync_report is not None:
        from ray_tpu_torch.devtools import syncdebug
        try:
            with open(args.sync_report, encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            print(f"cannot read sync report {args.sync_report!r}: {e}")
            return 2
        print(syncdebug.format_sync(doc))
        return 0
    paths = list(args.paths)
    if args.changed:
        try:
            paths += mod.changed_python_files(base=args.base)
        except RuntimeError as e:
            print(f"--changed: {e}")
            return 2
        if not paths:
            print("0 finding(s) in 0 file(s)")
            return 0
    if not paths:
        paths = ["."]
    result = mod.lint_paths(paths)
    out = {"text": mod.format_text, "json": mod.format_json,
           "github": mod.format_github}[args.fmt](result)
    if out:
        print(out)
    sys.stdout.flush()
    return 0 if result.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
