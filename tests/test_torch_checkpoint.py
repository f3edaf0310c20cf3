"""The port's checkpoint wire format against the JAX package's, on the CPU.

Checkpoints written by ``ray_tpu.checkpoint.format`` (params and optax adamw
state, fp32 and bf16, from one device and from JAX's 8-device dp2xfsdp4
mesh) restore into ``ray_tpu_torch.checkpoint.format`` bit-exact, and the
port's restore into JAX bit-exact.  The port's own mesh reshapes (dp2 ->
fsdp2, fsdp4 -> dp2xfsdp2, the matrix of ``tests/test_train_mesh.py``) run
over gloo process groups, one process a rank, and are bit-exact too.
Integrity: a flipped byte raises ``CheckpointError``; a directory without a
manifest is not a checkpoint; the skeleton unpickler refuses foreign
classes and imports none of JAX, optax or the JAX package.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from ray_tpu.checkpoint import format as JF
from ray_tpu.models import llama as j_llama
from ray_tpu.parallel import MeshSpec as JMeshSpec
from ray_tpu.parallel import build_mesh as j_build_mesh
from ray_tpu.train.mesh import runtime as j_runtime
from ray_tpu_torch import optim
from ray_tpu_torch._tree import tree_flatten_with_keys, tree_leaves
from ray_tpu_torch.checkpoint import format as TF
from ray_tpu_torch.models import llama as t_llama
from ray_tpu_torch.parallel.launch import run_local

TINY = dict(vocab_size=64, hidden=32, layers=2, heads=4, kv_heads=2,
            head_dim=8, mlp_dim=64, max_seq_len=32)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bits(x) -> np.ndarray:
    """An array's raw bytes as integers of its width (bit-exact compare;
    bf16 without ml_dtypes on the torch side)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        width = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                 8: torch.int64}[t.element_size()]
        return t.view(width).numpy()
    a = np.ascontiguousarray(np.asarray(x))
    return a.view({1: np.uint8, 2: np.int16, 4: np.int32,
                   8: np.int64}[a.dtype.itemsize])


def _jax_state(dtype):
    """JAX params and adamw state after one update (mu, nu non-zero)."""
    cfg = j_llama.LlamaConfig(**TINY, dtype=dtype, remat=False,
                              attention_impl="reference")
    params = j_llama.init_params(cfg, jax.random.key(0), param_dtype=dtype)
    opt = optax.adamw(1e-3, b1=0.9, b2=0.95, weight_decay=0.1)
    state = opt.init(params)
    grads = jax.tree.map(lambda p: jnp.full_like(p, 0.01), params)
    updates, state = opt.update(grads, state, params)
    return optax.apply_updates(params, updates), state


def _jax_save(tree, dirpath):
    snap = JF.snapshot_tree(tree)
    index, blob = JF.build_shard(snap, 0, 1, 3)
    JF.write_shard(dirpath, index, blob, skeleton_pkl=snap.skeleton_pkl)
    JF.commit_manifest(dirpath, JF.build_manifest(dirpath, 3, 1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["one_device", "dp2xfsdp4"])
def test_jax_checkpoint_restores_into_the_port_bit_exact(tmp_path, dtype,
                                                         layout):
    params, state = _jax_state(jnp.dtype(dtype))
    if layout == "dp2xfsdp4":
        mesh = j_build_mesh(JMeshSpec(dp=2, fsdp=4),
                            devices=jax.devices()[:8])
        cfg = j_llama.LlamaConfig(**TINY)
        params = j_runtime.shard_tree(
            jax.tree.map(np.asarray, params), j_llama.param_logical_axes(cfg),
            mesh)
        assert not params["blocks"]["wq"].is_fully_replicated
    tree = {"params": params, "opt_state": state, "step": 3}
    _jax_save(tree, str(tmp_path))
    got = TF.restore_tree(str(tmp_path))
    assert got["step"] == 3
    adam = optim.from_optax_state(got["opt_state"])
    assert isinstance(adam, optim.AdamState)
    assert all(isinstance(s, optim.EmptyState) for s in got["opt_state"][1:])
    # JAX's own restore of the same files: the shapes it wrote (a scalar
    # goes through np.ascontiguousarray, so JAX stores the count as [1]).
    jax_restored = dict(
        (JF._key_str(path), leaf) for path, leaf in
        jax.tree_util.tree_flatten_with_path(JF.restore_tree(
            str(tmp_path)))[0])
    want_leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    got_leaves = dict(tree_flatten_with_keys(got))
    assert len(got_leaves) == len(want_leaves)
    for path, leaf in want_leaves:
        key = JF._key_str(path)
        if key == "step":
            continue
        t = got_leaves[key]
        assert str(t.dtype).split(".")[-1] == str(np.asarray(leaf).dtype), key
        assert tuple(t.shape) == np.shape(jax_restored[key]), key
        np.testing.assert_array_equal(_bits(t).reshape(-1),
                                      _bits(leaf).reshape(-1), err_msg=key)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_port_checkpoint_restores_into_jax_bit_exact(tmp_path, dtype):
    cfg = t_llama.LlamaConfig(**TINY)
    params = t_llama.init_params(cfg, torch.Generator().manual_seed(1),
                                 param_dtype=dtype, device="cpu")
    state = optim.adamw(1e-3).init(params)
    grads = [torch.full_like(p, 0.01) for p in tree_leaves(params)]
    state = optim.adamw(1e-3).update(grads, state, params)
    tree = {"params": params, "opt_state": optim.optax_state(state),
            "step": 3}
    TF.save(str(tmp_path), tree, step=3)
    assert JF.verify_checkpoint(str(tmp_path), deep=True) == []
    out = JF.restore_tree(str(tmp_path))
    assert out["step"] == 3
    assert type(out["opt_state"][0]).__name__ == "ScaleByAdamState"
    assert isinstance(out["opt_state"][1], optax.EmptyState)
    # JAX sees the structure of its own adamw state for these params.
    j_params = jax.tree.map(jnp.asarray, out["params"])
    assert jax.tree.structure(out["opt_state"]) == jax.tree.structure(
        optax.adamw(1e-3).init(j_params))
    want = dict(tree_flatten_with_keys(tree))
    got = jax.tree_util.tree_flatten_with_path(out)[0]
    assert len(got) == len(want)
    for path, leaf in got:
        key = JF._key_str(path)
        if key == "step":
            continue
        t = want[key]
        assert str(np.asarray(leaf).dtype) == str(t.dtype).split(".")[-1]
        np.testing.assert_array_equal(_bits(leaf), _bits(t), err_msg=key)


def test_port_round_trips_its_own_trees(tmp_path):
    tree = {"a": [torch.arange(6, dtype=torch.int64).reshape(2, 3),
                  (torch.tensor(True), None)],
            "s": optim.AdamState(torch.tensor(2, dtype=torch.int32),
                                 {"w": torch.ones(2, dtype=torch.bfloat16)},
                                 {"w": torch.zeros(2)}),
            "n": "name", "e": optim.EmptyState()}
    TF.save(str(tmp_path), tree)
    got = TF.restore_tree(str(tmp_path))
    assert got["n"] == "name" and got["e"] == optim.EmptyState()
    assert got["a"][1][1] is None and bool(got["a"][1][0])
    assert torch.equal(got["a"][0], tree["a"][0])
    assert isinstance(got["s"], optim.AdamState)
    assert torch.equal(got["s"].mu["w"], tree["s"].mu["w"])
    assert got["s"].mu["w"].dtype == torch.bfloat16
    # A placement restores a slice.
    part = TF.restore_tree(str(tmp_path), placement=lambda k, s: (
        ((0, 1), (1, 3)) if k == "a/0" else None))
    assert torch.equal(part["a"][0], tree["a"][0][:1, 1:])


def test_a_flipped_byte_fails_closed(tmp_path):
    TF.save(str(tmp_path), {"w": torch.arange(64, dtype=torch.float32)})
    data = tmp_path / "shard-00000-of-00001.bin"
    raw = bytearray(data.read_bytes())
    raw[17] ^= 0x01
    data.write_bytes(bytes(raw))
    assert TF.verify_checkpoint(str(tmp_path)) == []   # sizes still match
    assert TF.verify_checkpoint(str(tmp_path), deep=True)
    with pytest.raises(TF.CheckpointError, match="crc"):
        TF.restore_tree(str(tmp_path))


def test_a_directory_without_a_manifest_is_not_a_checkpoint(tmp_path):
    TF.save(str(tmp_path), {"w": torch.ones(3)})
    (tmp_path / TF.MANIFEST).unlink()
    assert not TF.is_committed(str(tmp_path))
    assert TF.verify_checkpoint(str(tmp_path)) == [
        "no manifest (uncommitted or not a checkpoint)"]
    with pytest.raises(FileNotFoundError):
        TF.restore_tree(str(tmp_path))


def test_the_skeleton_unpickler_refuses_foreign_classes(tmp_path):
    import pickle
    TF.save(str(tmp_path), {"w": torch.ones(3)})
    (tmp_path / TF.SKELETON).write_bytes(pickle.dumps(
        {"w": JF._LeafMarker(), "x": os.path.join}))
    with pytest.raises(TF.CheckpointError, match="posixpath.join|os"):
        TF.restore_tree(str(tmp_path))


def test_reading_a_jax_checkpoint_imports_nothing_of_jax(tmp_path):
    params, state = _jax_state(jnp.bfloat16)
    _jax_save({"params": params, "opt_state": state}, str(tmp_path))
    code = (
        "import sys\n"
        "from ray_tpu_torch.checkpoint import format as F\n"
        f"t = F.restore_tree({str(tmp_path)!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'ray_tpu', 'ml_dtypes'))\n"
        "assert not bad, bad\n"
        "print(type(t['opt_state'][0]).__name__)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "AdamState"


# -- the reshape matrix over gloo ranks ---------------------------------------

_LOGICAL = {"w": ("embed", None), "stacked": ("layers", "embed", None),
            "b": (None,), "step": None}


def _host_tree():
    return {"w": np.arange(64, dtype=np.float32).reshape(8, 8),
            "stacked": np.arange(256, dtype=np.float32).reshape(4, 8, 8),
            "b": np.arange(8, dtype=np.float32), "step": 7}


def _reshape_worker(rank, world, desc_a, desc_b, dirpath):
    from ray_tpu_torch.checkpoint import format as F
    from ray_tpu_torch.parallel import MeshSpec, build_mesh
    from ray_tpu_torch.train.mesh import reshape as R
    from ray_tpu_torch.train.mesh.runtime import shard_tree

    def spec(desc):
        return MeshSpec(**{re.match(r"[a-z]+", p).group():
                           int(re.search(r"\d+", p).group())
                           for p in desc.split("x")})

    mesh_a, mesh_b = build_mesh(spec(desc_a)), build_mesh(spec(desc_b))
    host = _host_tree()
    tree = shard_tree({k: host[k] for k in ("w", "stacked", "b")},
                      {k: _LOGICAL[k] for k in ("w", "stacked", "b")},
                      mesh_a)
    if "fsdp" in desc_a:                  # really sharded on the save side
        assert tuple(tree["w"].to_local().shape) != (8, 8)
    tree["step"] = host["step"]
    F.save(dirpath, tree, metrics=R.save_metrics(mesh_a))
    out = R.restore_to_mesh(dirpath, R.sharding_tree(_LOGICAL, mesh_b))
    full = {k: out[k].full_tensor().numpy() for k in ("w", "stacked", "b")}
    local = {k: tuple(out[k].to_local().shape) for k in ("w", "b")}
    return (full, out["step"], local, F.read_manifest(dirpath)["metrics"],
            len(F.read_manifest(dirpath)["shards"]))


@pytest.mark.parametrize("desc_a,desc_b,world", [("dp2", "fsdp2", 2),
                                                 ("fsdp4", "dp2xfsdp2", 4)])
def test_reshape_bit_exact(tmp_path, desc_a, desc_b, world):
    results = run_local(_reshape_worker, world, str(tmp_path), desc_a,
                        desc_b, str(tmp_path / "ckpt"), timeout=120)
    host = _host_tree()
    for rank, (full, step, local, metrics, shards) in enumerate(results):
        for key in ("w", "stacked", "b"):
            np.testing.assert_array_equal(full[key], host[key])
        assert step == 7 and metrics == {"mesh": desc_a} and shards == world
        # fsdp shards w's embed dim; b is replicated.
        assert local["w"] == (8 // 2, 8) and local["b"] == (8,)


# -- MoE and pipeline layouts -------------------------------------------------

# (mesh, config): experts split over ep; layers split over pp (JAX's
# rules.replace(layers="pp")).
_LAYOUTS = {"moe_dp2xep4": (dict(dp=2, ep=4), dict(num_experts=4)),
            "pp2xfsdp4": (dict(pp=2, fsdp=4), dict(layers=4))}


def _layout_rules(name, module):
    rules = module.default_rules()
    return rules.replace(layers="pp") if name.startswith("pp") else rules


def _layout_state(name):
    """JAX params and adamw state of the layout's config, one update in,
    laid out on its 8-device mesh."""
    from ray_tpu.parallel import sharding as j_sharding
    spec, kw = _LAYOUTS[name]
    cfg = j_llama.LlamaConfig(**dict(TINY, **kw), dtype=jnp.float32)
    params = j_llama.init_params(cfg, jax.random.key(0))
    opt = optax.adamw(1e-3, b1=0.9, b2=0.95, weight_decay=0.1)
    state = opt.init(params)
    grads = jax.tree.map(lambda p: jnp.full_like(p, 0.01), params)
    updates, state = opt.update(grads, state, params)
    params = optax.apply_updates(params, updates)
    mesh = j_build_mesh(JMeshSpec(**spec), devices=jax.devices()[:8])
    rules = _layout_rules(name, j_sharding)
    logical = j_llama.param_logical_axes(cfg)
    params = j_runtime.shard_tree(jax.tree.map(np.asarray, params), logical,
                                  mesh, rules)
    return cfg, params, state


def _layout_worker(rank, world, name, jax_dir, port_dir):
    """Restore JAX's checkpoint onto the port's mesh of the same layout
    (this rank's blocks), then save the port's own sharded copy."""
    from ray_tpu_torch.checkpoint import format as F
    from ray_tpu_torch.parallel import MeshSpec, build_mesh
    from ray_tpu_torch.parallel import sharding as t_sharding
    from ray_tpu_torch.train.mesh import reshape as R
    spec, kw = _LAYOUTS[name]
    mesh = build_mesh(MeshSpec(**spec))
    cfg = t_llama.LlamaConfig(**dict(TINY, **kw))
    logical = {"params": t_llama.param_logical_axes(cfg)}
    shardings = R.sharding_tree(logical, mesh,
                                _layout_rules(name, t_sharding))
    out = R.restore_to_mesh(jax_dir, dict(
        shardings, opt_state=None, step=None))
    split = {k: [str(p) for p in v.placements]
             for k, v in out["params"]["blocks"].items()}
    blocks = {k: (v.to_local().numpy(), t_sharding.dtensor_index(v))
              for k, v in out["params"]["blocks"].items()}
    F.save(port_dir, {"params": out["params"]}, step=3)
    return split, blocks


@pytest.mark.parametrize("name", list(_LAYOUTS))
def test_moe_and_pipeline_checkpoints_cross_bit_exact(tmp_path, name):
    """A JAX checkpoint of an MoE model laid out over ep, and of a model
    whose layers are split over pp, restores into the port bit-exact (whole,
    and onto the port's mesh of the same layout, each rank its blocks); the
    port's sharded save of it restores into JAX bit-exact."""
    cfg, params, state = _layout_state(name)
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    os.makedirs(jax_dir)
    os.makedirs(port_dir)
    tree = {"params": params, "opt_state": state, "step": 3}
    _jax_save(tree, jax_dir)
    got = dict(tree_flatten_with_keys(TF.restore_tree(jax_dir)))
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = JF._key_str(path)
        if key != "step":
            np.testing.assert_array_equal(_bits(got[key]).reshape(-1),
                                          _bits(leaf).reshape(-1),
                                          err_msg=key)
    ranks = run_local(_layout_worker, 8, str(tmp_path), name, jax_dir,
                      port_dir, timeout=120)
    from ray_tpu_torch.parallel.mesh import CANONICAL_ORDER
    axis = "ep" if name.startswith("moe") else "pp"
    for split, blocks in ranks:
        assert split["w_gate"][CANONICAL_ORDER.index(axis)] == (
            "S(1)" if axis == "ep" else "S(0)")
        for k, (block, box) in blocks.items():
            whole = np.asarray(params["blocks"][k])
            np.testing.assert_array_equal(
                block, whole[tuple(slice(lo, hi) for lo, hi in box)],
                err_msg=k)
    back = dict((JF._key_str(p), v) for p, v in
                jax.tree_util.tree_flatten_with_path(
                    JF.restore_tree(port_dir))[0])
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            {"params": params})[0]:
        key = JF._key_str(path)
        np.testing.assert_array_equal(_bits(back[key]), _bits(leaf),
                                      err_msg=key)
