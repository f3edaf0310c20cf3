"""The port's lint core, CFG and eager-torch RT5xx rules
(``ray_tpu_torch.devtools``) against the JAX package's
``ray_tpu.devtools``.

``dataflow.build_cfg`` of both packages on the sources of
``tests/test_lint_jax.py::TestTracedTaintCfg`` (and a few with try,
with, break and continue): the same nodes and edges.  The noqa parsing of
both on the same lines: the same map.  Then RT502 (a host coercion of a
CUDA tensor per loop iteration), RT504 (a read of the gradients after
``AdamW.update`` used them as scratch) and RT505 (generators seeded
alike), each positive, negative and suppressed, in torch spelling; the
catalog lists RT501/RT503/RT506 as not carried; the command line; and
``lint_paths`` over ``ray_tpu_torch/`` with its findings recorded.
"""

from __future__ import annotations

import ast
import os
import subprocess
import sys
import textwrap

import pytest

from ray_tpu_torch.devtools import dataflow, lint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: Sources of TestTracedTaintCfg (tests/test_lint_jax.py:116), then CFG
#: shapes the taint tests do not reach.
CFG_SOURCES = [
    "def f(x, y):\n    if y:\n        z = x * 2\n    else:\n        z = 1\n"
    "    w = z\n    return w\n",
    "def f(x):\n    y = x + 1\n    x = 0\n    z = x\n    return z\n",
    "def f(x):\n    n = x.shape[0]\n    return n\n",
    "def f(x, items):\n    acc = 0\n    for it in items:\n"
    "        acc = acc + x\n    return acc\n",
    "def f(x):\n    return x\n",
    textwrap.dedent("""\
        def f(a, lock):
            with lock:
                try:
                    for i in a:
                        if i:
                            continue
                        if i > 3:
                            break
                    else:
                        return 1
                except ValueError as e:
                    raise RuntimeError() from e
                finally:
                    a.clear()
            while a:
                a.pop()
            return 0
        """),
]


def _cfg_shape(cfg):
    return ([(n.idx, n.kind, None if n.stmt is None else
              (type(n.stmt).__name__, n.stmt.lineno, n.stmt.col_offset))
             for n in cfg.nodes],
            {k: sorted(v) for k, v in cfg.succ.items()},
            cfg.entry, cfg.exit)


@pytest.mark.parametrize("i", range(len(CFG_SOURCES)))
def test_cfg_matches_jax(i):
    from ray_tpu.devtools import dataflow as jax_dataflow
    fn = ast.parse(CFG_SOURCES[i]).body[0]
    got = _cfg_shape(dataflow.build_cfg(fn))
    want = _cfg_shape(jax_dataflow.build_cfg(ast.parse(
        CFG_SOURCES[i]).body[0]))
    assert got == want
    assert len(got[0]) >= 3


def test_noqa_map_matches_jax():
    from ray_tpu.devtools import lint as jax_lint
    src = ("x = 1  # ray-tpu: noqa[RT502]\n"
           "y = 2  # ray-tpu: noqa\n"
           "z = 3  # ray-tpu: noqa[rt504, RT505]\n"
           "w = 4  # noqa\n")
    assert lint._noqa_map(src) == jax_lint._noqa_map(src)


def ids(src):
    return [f.rule for f in lint.lint_source(textwrap.dedent(src))]


class TestHostSyncRT502:
    BAD = """
    import torch

    def metrics(batches, model):
        out = []
        for b in batches:
            m = model(b.cuda()).sum()
            out.append(m.item())
        return out

    def per_element(n, device):
        t = torch.arange(n, device=device)
        return [int(v) for v in t]
    """
    GOOD = """
    import torch

    def metrics(batches, model):
        ms = torch.stack([model(b.cuda()).sum() for b in batches])
        return ms.cpu().tolist()

    def once(n, device):
        t = torch.arange(n, device=device)
        host = t.cpu()
        return [int(v) for v in host]

    def cpu_only(n):
        t = torch.arange(n)
        return [int(v) for v in t]
    """

    def test_positive(self):
        found = lint.lint_source(textwrap.dedent(self.BAD))
        assert [f.rule for f in found] == ["RT502", "RT502"]
        assert ".item()" in found[0].message and "int()" in found[1].message

    def test_negative(self):
        assert ids(self.GOOD) == []

    def test_one_sync_outside_loop_ok(self):
        assert ids("""
        import torch
        def loss(x):
            y = x.to("cuda").sum()
            return float(y)
        """) == []

    def test_each_patched_spelling(self):
        src = """
        import numpy as np
        import torch
        def f(xs):
            t = torch.ones(4, device="cuda")
            for _ in xs:
                float(t[0]); int(t[0]); bool(t[0]); complex(t[0])
                t.tolist(); t.numpy(); t.__array__(); np.asarray(t)
        """
        assert ids(src) == ["RT502"] * 8

    def test_suppression(self):
        src = textwrap.dedent(self.BAD).replace(
            "out.append(m.item())", "out.append(m.item())  # ray-tpu: "
            "noqa[RT502]")
        assert [f.rule for f in lint.lint_source(src)] == ["RT502"]


class TestScratchReadRT504:
    BAD = """
    from ray_tpu_torch.optim import adamw, global_norm

    opt = adamw(1e-3)

    def step(grads, state, params):
        state = opt.update(grads, state, params)
        return state, global_norm(grads)
    """

    def test_positive(self):
        (f,) = lint.lint_source(textwrap.dedent(self.BAD))
        assert f.rule == "RT504" and "'grads'" in f.message

    def test_negative_read_before_update(self):
        assert ids("""
        from ray_tpu_torch.optim import adamw, global_norm
        opt = adamw(1e-3)
        def step(grads, state, params):
            norm = global_norm(grads)
            state = opt.update(grads, state, params)
            return state, norm
        """) == []

    def test_rebind_on_every_path_clears_it(self):
        assert ids("""
        import torch
        class L:
            def __init__(self):
                self.opt = torch_optim_adamw = None
                self.opt = AdamW(1e-3)
            def run(self, batches, state, params):
                for b in batches:
                    grads = compute(b)
                    state = self.opt.update(grads, state, params)
                return state
        """) == []

    def test_read_on_one_branch_is_found(self):
        assert ids("""
        import torch
        from ray_tpu_torch import optim
        opt = optim.adamw(1e-3)
        def step(grads, state, params, log):
            state = opt.update(grads, state, params)
            if log:
                print(grads)
            else:
                grads = None
            return state
        """) == ["RT504"]

    def test_suppression(self):
        src = textwrap.dedent(self.BAD).replace(
            "state = opt.update(grads, state, params)",
            "state = opt.update(grads, state, params)  # ray-tpu: "
            "noqa[RT504]")
        assert ids(src) == []


class TestRandomStreamsRT505:
    def test_reseeded_in_loop(self):
        found = lint.lint_source(textwrap.dedent("""
        import torch
        def noise(n, shape):
            out = []
            for _ in range(n):
                g = torch.Generator(device="cuda").manual_seed(0)
                out.append(torch.randn(shape, generator=g))
            return out
        """))
        assert [f.rule for f in found] == ["RT505"]
        assert "every iteration" in found[0].message

    def test_global_reseed_in_loop(self):
        assert ids("""
        import torch
        def noise(n, seed):
            for _ in range(n):
                torch.manual_seed(seed)
                x = torch.rand(3)
            return x
        """) == ["RT505"]

    def test_seed_from_iteration_ok(self):
        assert ids("""
        import torch
        def noise(n, base):
            for i in range(n):
                g = torch.Generator().manual_seed(base + i)
                x = torch.rand(3, generator=g)
            return x
        """) == []

    def test_two_generators_seeded_alike(self):
        found = lint.lint_source(textwrap.dedent("""
        import torch
        def pair(shape):
            ga = torch.Generator().manual_seed(7)
            gb = torch.Generator().manual_seed(7)
            return (torch.randn(shape, generator=ga),
                    torch.rand(shape, generator=gb))
        """))
        assert [f.rule for f in found] == ["RT505"]
        assert "'ga' and 'gb'" in found[0].message

    def test_one_generator_used_twice_ok(self):
        # A torch generator advances as it is used: JAX's key reuse is not
        # a bug here.
        assert ids("""
        import torch
        def pair(shape):
            g = torch.Generator().manual_seed(7)
            return torch.randn(shape, generator=g), torch.rand(
                shape, generator=g)
        """) == []

    def test_suppression(self):
        assert ids("""
        import torch
        def noise(n):
            for _ in range(n):
                torch.manual_seed(0)  # ray-tpu: noqa[RT505]
        """) == []


def test_catalog_lists_the_rules_not_carried():
    text = lint.rule_catalog_text()
    for rid in ("RT502", "RT504", "RT505"):
        assert f"{rid} [{'dataflow' if rid == 'RT504' else 'ast'}]" in text
    for rid in ("RT501", "RT503", "RT506"):
        assert f"{rid} [not carried]" in text
    assert {r.id for r in lint.iter_rules()} == {"RT502", "RT504", "RT505"}
    explain = lint.explain_text("rt502")
    assert "Bad:" in explain and "noqa[RT502]" in explain


def test_cli(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent(TestHostSyncRT502.BAD))
    env = dict(os.environ, PYTHONPATH=REPO)
    run = lambda *a: subprocess.run(  # noqa: E731
        [sys.executable, "-m", "ray_tpu_torch.devtools.lint", *a],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    out = run(str(bad))
    assert out.returncode == 1 and out.stdout.count("RT502") == 2
    assert out.stdout.strip().endswith("2 finding(s) in 1 file(s)")
    out = run("--format", "json", str(bad))
    import json
    assert [f["rule"] for f in json.loads(out.stdout)["findings"]] == \
        ["RT502", "RT502"]
    assert run("--list-rules").returncode == 0


def test_lint_paths_over_the_port():
    """The port's own tree under its rules, recorded (nothing repaired
    here): no finding."""
    result = lint.lint_paths([os.path.join(REPO, "ray_tpu_torch")])
    assert result.files_checked > 100
    assert [(f.rule, os.path.relpath(f.path, REPO), f.line)
            for f in result.findings] == []
