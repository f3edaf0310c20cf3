"""The CUDA host-sync tripwire (``ray_tpu_torch.devtools.syncdebug``)
against the JAX package's ``ray_tpu.devtools.syncdebug``.

``format_sync`` renders the same report (seeded per-site rows, an empty
one, a truncated one) to the same text in both packages, and the two
``report()`` documents have the same keys.  ``install``/``uninstall``
put ``torch.Tensor``'s own methods back.  There is no card here, so the
CUDA predicate is stubbed inside the tests (``syncdebug._is_cuda``; not a
user knob): an ``.item()`` per element in a loop is then one site counted
N times at its own line, a nested coercion counts once, CPU tensors pass
uncounted, and the sampled publish reaches the catalog series.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ray_tpu_torch.devtools import syncdebug

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def tripwire(monkeypatch):
    """The tripwire installed and cleared, every tensor counted as if it
    lay on the card."""
    monkeypatch.setattr(syncdebug, "_is_cuda", lambda t: True)
    syncdebug.clear()
    syncdebug.install()
    yield syncdebug
    syncdebug.uninstall()
    syncdebug.clear()


def _seeded_report(seed, n_sites, top=50):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n_sites):
        count = int(rng.integers(1, 500))
        total = float(rng.uniform(1e-7, 3.0))
        rows.append({"site": f"module_{i}.py:{int(rng.integers(1, 900))}",
                     "kind": ["item", "tolist", "__float__"][i % 3],
                     "count": count, "total_s": total,
                     "mean_s": total / count,
                     "max_s": float(rng.uniform(total / count, total)),
                     "hist": [int(x) for x in rng.integers(0, 50, 8)]})
    rows.sort(key=lambda r: (-r["total_s"], -r["count"]))
    return {"installed": True, "pid": 1234,
            "bucket_bounds_s": list(syncdebug._BOUNDS),
            "total_syncs": sum(r["count"] for r in rows),
            "cached_fastpath": 0, "total_sites": len(rows),
            "truncated": max(0, len(rows) - top), "sites": rows[:top]}


@pytest.mark.parametrize("seed,n_sites,top", [(0, 5, 50), (1, 12, 4),
                                              (2, 0, 50)])
def test_format_sync_matches_jax(seed, n_sites, top):
    from ray_tpu.devtools import syncdebug as jax_syncdebug
    doc = _seeded_report(seed, n_sites, top)
    assert syncdebug.format_sync(doc) == jax_syncdebug.format_sync(doc)


def test_report_shape_matches_jax():
    from ray_tpu.devtools import syncdebug as jax_syncdebug
    jax_syncdebug.clear()
    syncdebug.clear()
    assert set(syncdebug.report()) == set(jax_syncdebug.report())
    assert syncdebug._BOUNDS == jax_syncdebug._BOUNDS
    assert syncdebug._PUBLISH_EVERY == jax_syncdebug._PUBLISH_EVERY
    assert set(jax_syncdebug._COERCIONS) < set(syncdebug._COERCIONS)


def test_install_uninstall_restores_tensor_methods():
    before = {k: torch.Tensor.__dict__.get(k) for k in syncdebug._COERCIONS}
    resolved = {k: getattr(torch.Tensor, k) for k in syncdebug._COERCIONS}
    syncdebug.install()
    try:
        assert syncdebug.is_installed()
        for k in syncdebug._COERCIONS:
            assert hasattr(getattr(torch.Tensor, k), "_ray_tpu_sync_orig")
        syncdebug.install()                       # idempotent
    finally:
        syncdebug.uninstall()
    assert not syncdebug.is_installed()
    assert {k: torch.Tensor.__dict__.get(k)
            for k in syncdebug._COERCIONS} == before
    assert {k: getattr(torch.Tensor, k)
            for k in syncdebug._COERCIONS} == resolved


def test_item_per_element_is_one_site_counted_n_times(tripwire):
    x = torch.arange(17, dtype=torch.float32)
    out = []
    for i in range(len(x)):
        out.append(x[i].item())                  # the planted sync
    line = sys._getframe().f_lineno - 1
    assert out == list(range(17))
    rep = tripwire.report()
    (row,) = [r for r in rep["sites"] if r["kind"] == "item"]
    assert row["site"] == f"test_torch_syncdebug.py:{line}"
    assert row["count"] == 17 and sum(row["hist"]) == 17
    assert rep["total_syncs"] == 17 and rep["cached_fastpath"] == 0


def test_each_coercion_counted_once(tripwire):
    t = torch.tensor([1.5, 2.5])
    s = torch.tensor(3)
    float(t[0]), int(s), bool(s), complex(t[1]), [0, 1, 2, 3][s]
    t.tolist(), t.numpy(), np.asarray(t)
    kinds = sorted(r["kind"] for r in tripwire.report()["sites"])
    assert kinds == sorted(["__float__", "__int__", "__bool__",
                            "__complex__", "__index__", "tolist", "numpy",
                            "__array__"])
    assert tripwire.report()["total_syncs"] == 8


def test_cpu_tensors_pass_uncounted():
    syncdebug.clear()
    syncdebug.install()
    try:
        t = torch.arange(5)
        assert [t[i].item() for i in range(5)] == [0, 1, 2, 3, 4]
        assert t.tolist() == [0, 1, 2, 3, 4]
        assert syncdebug.report()["total_syncs"] == 0
    finally:
        syncdebug.uninstall()


def test_sampled_publish_reaches_catalog(tripwire):
    from ray_tpu_torch.util import telemetry
    telemetry._reset_for_tests()
    x = torch.ones(65)
    for i in range(65):
        x[i].item()
    (series,) = telemetry.samples("ray_tpu_jax_host_sync_total").values()
    # Published at the 1st and the 65th sync of the site, 64 each time.
    assert series[1] == 2 * syncdebug._PUBLISH_EVERY
    assert series[0]["site"].startswith("test_torch_syncdebug.py:")
    (hist,) = telemetry.samples("ray_tpu_jax_host_sync_seconds").values()
    assert hist[1] == 2
    telemetry._reset_for_tests()


def test_env_var_installs_at_import():
    code = ("import ray_tpu_torch\n"
            "from ray_tpu_torch.devtools import syncdebug\n"
            "print(syncdebug.is_installed())\n")
    env = dict(os.environ, RAY_TPU_SYNC_DEBUG="1", PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "True", out.stderr


def test_cli_renders_saved_report(tmp_path):
    import json
    doc = _seeded_report(3, 4)
    path = tmp_path / "sync_findings.json"
    path.write_text(json.dumps(doc))
    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.devtools.lint",
         "--sync-report", str(path)], cwd=REPO, capture_output=True,
        text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.rstrip("\n") == syncdebug.format_sync(doc)
