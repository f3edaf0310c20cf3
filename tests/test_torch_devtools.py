"""The port's lint engine and rule families (``ray_tpu_torch.devtools``)
against the JAX package's.

- Every RT1xx-RT4xx rule's own ``example_bad`` and ``example_good``,
  through both packages' ``lint_source`` (``ray_tpu`` mapped to
  ``ray_tpu_torch`` in the port's copy), give the same rule ids on the
  same lines; the port's examples are the mapped JAX ones.
- Every corpus of ``tests/test_dataflow.py`` and ``tests/test_lint.py``
  (their inline sources, read from the files) gives the same findings of
  those families through both engines, and ``analyze_function`` /
  ``iter_function_leaks`` give the same leaks on the dataflow corpora.
- The self-lint gate: ``ray_tpu_torch/`` walked with the internal rules
  on has exactly the findings listed in ``STANDING`` (each naming its
  ROADMAP Queue 3 item), no more and no fewer: none today.
"""

from __future__ import annotations

import ast
import os
import pathlib
import re

import pytest

from ray_tpu_torch.devtools import dataflow as p_dataflow
from ray_tpu_torch.devtools import lint as p_lint

REPO = pathlib.Path(__file__).resolve().parent.parent

#: The rule families both packages carry (RT5xx differs by framework).
FAMILIES = ("RT1", "RT2", "RT3", "RT4")


def _jax_lint():
    from ray_tpu.devtools import lint
    return lint


def _to_port(src: str) -> str:
    return re.sub(r"\bray_tpu\b", "ray_tpu_torch", src)


def _ids(findings):
    return [(f.rule, f.line) for f in findings
            if f.rule.startswith(FAMILIES) or f.rule == "RT001"]


def _family_rules():
    from ray_tpu.devtools import lint
    return sorted((r for r in lint.iter_rules()
                   if r.id.startswith(FAMILIES)), key=lambda r: r.id)


_JAX_RULE_IDS = [r.id for r in _family_rules()]


@pytest.mark.parametrize("which", ["bad", "good"])
@pytest.mark.parametrize("rule_id", _JAX_RULE_IDS)
def test_rule_examples_match_jax(rule_id, which):
    j = next(r for r in _jax_lint().iter_rules() if r.id == rule_id)
    p = next(r for r in p_lint.iter_rules() if r.id == rule_id)
    assert p.scope == j.scope and p.dataflow == j.dataflow
    src = getattr(j, f"example_{which}")
    assert getattr(p, f"example_{which}") == _to_port(src)
    internal = j.scope == "internal"
    want = _ids(_jax_lint().lint_source(src, internal=internal))
    got = _ids(p_lint.lint_source(_to_port(src), internal=internal))
    assert got == want


def test_port_carries_every_family_rule():
    port = {r.id for r in p_lint.iter_rules()}
    assert set(_JAX_RULE_IDS) <= port
    assert {"RT502", "RT504", "RT505"} <= port


def _corpora(name: str):
    """Inline sources of a test file: multi-line string constants that
    parse as Python and define something."""
    tree = ast.parse((REPO / "tests" / name).read_text())
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and "\n" in node.value:
            try:
                ast.parse(node.value)
            except SyntaxError:
                continue
            if re.search(r"\b(def|class|for|with)\b", node.value) and \
                    node.value not in out:
                out.append(node.value)
    return out


DATAFLOW_CORPORA = _corpora("test_dataflow.py")
LINT_CORPORA = _corpora("test_lint.py")


@pytest.mark.parametrize("i", range(len(DATAFLOW_CORPORA + LINT_CORPORA)))
def test_corpus_findings_match_jax(i):
    src = (DATAFLOW_CORPORA + LINT_CORPORA)[i]
    path = "ray_tpu/somepkg/mod.py"
    want = _ids(_jax_lint().lint_source(src, path=path, internal=True))
    got = _ids(p_lint.lint_source(_to_port(src), path=_to_port(path),
                                  internal=True))
    assert got == want


def _leak_key(leak):
    r = leak.resource
    return (leak.kind, r.family, r.key, r.label, r.call.lineno,
            leak.handler_line, leak.has_release)


@pytest.mark.parametrize("i", range(len(DATAFLOW_CORPORA)))
def test_dataflow_leaks_match_jax(i):
    from ray_tpu.devtools import dataflow as j_dataflow
    src = DATAFLOW_CORPORA[i]
    j_tree, p_tree = ast.parse(src), ast.parse(_to_port(src))
    want = [(fn.name, _leak_key(lk))
            for fn, lk in j_dataflow.iter_function_leaks(j_tree)]
    got = [(fn.name, _leak_key(lk))
           for fn, lk in p_dataflow.iter_function_leaks(p_tree)]
    assert got == want
    for j_fn, p_fn in zip(
            [n for n in ast.walk(j_tree) if isinstance(n, ast.FunctionDef)],
            [n for n in ast.walk(p_tree) if isinstance(n, ast.FunctionDef)]):
        assert [_leak_key(lk) for lk in p_dataflow.analyze_function(p_fn)] \
            == [_leak_key(lk) for lk in j_dataflow.analyze_function(j_fn)]


def test_lock_held_map_matches_jax():
    from ray_tpu.devtools import dataflow as j_dataflow
    src = """
def f(self):
    with self._lock:
        self.a = 1
    self._lock.acquire()
    try:
        self.b = 2
    finally:
        self._lock.release()
    self.c = 3
"""
    j_fn = ast.parse(src).body[0]
    p_fn = ast.parse(src).body[0]
    locks = {"self._lock"}

    def shape(out):
        cfg, held = out
        return sorted((cfg.nodes[k].line, k, tuple(sorted(v)))
                      for k, v in held.items())

    got = shape(p_dataflow.lock_held_map(p_fn, locks))
    assert got == shape(j_dataflow.lock_held_map(j_fn, locks))
    assert any(v == ("self._lock",) for _line, _k, v in got)


def test_internal_scope_follows_the_port_tree(tmp_path):
    """Internal rules run on files under a ``ray_tpu_torch`` directory
    only (JAX: under ``ray_tpu``)."""
    src = ("import time\n\n\ndef f():\n    t0 = time.time()\n"
           "    return time.time() - t0\n")
    inside = tmp_path / "ray_tpu_torch" / "mod.py"
    outside = tmp_path / "user" / "mod.py"
    for f in (inside, outside):
        f.parent.mkdir(parents=True)
        f.write_text(src)
    assert [f.rule for f in p_lint.lint_paths([str(inside)]).findings] \
        == ["RT203"]
    assert p_lint.lint_paths([str(outside)]).findings == []
    assert p_lint.lint_paths([str(outside)], internal=True).findings


def test_noqa_and_detached_markers():
    src = ("def f(h):\n    h.ping.remote()\n\n\n"
           "def g(h):\n    h.ping.remote()  # ray-tpu: detached\n\n\n"
           "def k(h):\n    h.ping.remote()  # ray-tpu: noqa[RT302]\n")
    counts: dict = {}
    found = p_lint.lint_source(src, internal=True, suppressed_counts=counts)
    assert [(f.rule, f.line) for f in found] == [("RT302", 2)]
    assert counts == {"RT302": 1}


def test_devtools_exports_match_jax():
    import ray_tpu.devtools as j
    import ray_tpu_torch.devtools as p
    assert p.__all__ == j.__all__
    for name in p.__all__:
        assert hasattr(p, name)


# -- the self-lint gate --------------------------------------------------------

#: Findings still standing in ``ray_tpu_torch/``: (path under the repo,
#: rule, the flagged line's text) -> its ROADMAP Queue 3 item.  Queue 3
#: item 15 (RT201 in the worker's driver link) was repaired in the PR that
#: added this gate.
STANDING: dict = {}


def test_ray_tpu_torch_tree_is_clean():
    """The port's self-lint gate (JAX: ``tests/test_lint.py``
    ``test_ray_tpu_tree_is_clean``): the tree, walked with the internal
    rules on, has exactly the standing findings."""
    import ray_tpu_torch
    pkg = os.path.dirname(os.path.abspath(ray_tpu_torch.__file__))
    res = p_lint.lint_paths([pkg])
    assert res.files_checked > 100
    got = set()
    for f in res.findings:
        rel = os.path.relpath(f.path, REPO).replace(os.sep, "/")
        text = pathlib.Path(f.path).read_text().splitlines()[f.line - 1]
        got.add((rel, f.rule, text.strip()))
    assert got == set(STANDING), "\n" + p_lint.format_text(res)
