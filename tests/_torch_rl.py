"""Shared helpers of the port's RL tests: comparisons against the JAX
package's arrays and carrying its weights across.

Tolerance: fp32, 1e-5 (``F32``) relative to the largest magnitude of each
compared leaf.  Params and optimizer moments after Adam steps are held
relative to the largest magnitude in their whole tree
(``trees_close(..., whole_tree=True)``): the bias leaves start at exactly 0
and move by about the learning rate a step, and where a gradient element
nearly cancels, Adam's m / sqrt(v) turns the last-bit differences of
another summation order into ~1e-5 of such a leaf.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from ray_tpu_torch._tree import tree_leaves
from ray_tpu_torch.models import convert

F32 = 1e-5
CPU = "cpu"


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def close(got, want, tol=F32, what="", floor=1e-12):
    """max |got - want| <= tol * max(|want|, floor)."""
    got = np.asarray(_np(got), np.float64)
    want = np.asarray(_np(want), np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), floor)
    err = np.abs(got - want).max() / scale
    assert err <= tol, (what, err)


def trees_close(got, want, tol=F32, what="", whole_tree=False):
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w), (what, len(g), len(w))
    scale = max(float(np.abs(np.asarray(_np(x), np.float64)).max())
                for x in w) if whole_tree else None
    for i, (a, b) in enumerate(zip(g, w)):
        if whole_tree:
            a = np.asarray(_np(a), np.float64)
            b = np.asarray(_np(b), np.float64)
            assert a.shape == b.shape, (what, i, a.shape, b.shape)
            err = np.abs(a - b).max() / max(scale, 1e-12)
            assert err <= tol, (f"{what}[{i}]", err)
        else:
            close(a, b, tol, f"{what}[{i}]")


def to_port(tree):
    return convert.params_from_numpy(jax.tree.map(np.asarray, tree),
                                     device=CPU)


def t(x):
    return torch.from_numpy(np.array(x))


def rng(seed=0):
    return np.random.default_rng(seed)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The RL tests' tensors are tiny: one intra-op thread.  With torch's
    default (a thread a core) several test workers on one machine
    oversubscribe the cores, and the OpenMP threads' spin-waits slow a
    PPO run of these tests from ~1.5 s to minutes.  Restored after the
    module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
