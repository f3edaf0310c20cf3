"""The port's training slice against the JAX package's, on the CPU.

``models.llama.loss_fn`` and its gradients, the adamw step of
``parallel.spmd.make_lm_train_step`` and the optimizer state carried over by
``models.convert.opt_state_from_numpy`` go through both packages on the same
weights and batches (numpy seeds).  On CPU tensors the port's attention takes
its plain versions through the same ``autograd.Function`` as on the card.

Tolerances, each relative to the largest magnitude of the compared leaf:
fp32 1e-5 for losses, grad norms and gradients (another summation order);
fp32 params after three adamw steps 1e-5; bf16 losses 2e-2 (JAX's bf16 SiLU
rounds apart from torch's, tests/test_torch_llama.py).
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ray_tpu.models import llama as j_llama
from ray_tpu.parallel import MeshSpec as JMeshSpec
from ray_tpu.parallel import build_mesh as j_build_mesh
from ray_tpu.parallel.spmd import make_lm_train_step as j_train_step
from ray_tpu_torch import optim
from ray_tpu_torch._tree import tree_leaves, tree_map
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import llama as t_llama
from ray_tpu_torch.parallel import (MeshSpec, build_mesh, make_lm_eval_step,
                                    make_lm_train_step)

TINY = dict(vocab_size=256, hidden=64, layers=2, heads=4, kv_heads=2,
            head_dim=16, mlp_dim=128, max_seq_len=64)
J_CFG = j_llama.LlamaConfig(**TINY, dtype=jnp.float32, remat=False,
                            attention_impl="reference")
T_CFG = t_llama.LlamaConfig(**TINY, dtype=torch.float32, remat=False)
F32 = 1e-5
# The training config's learning rate.  Adam normalises each step to about
# lr per element, so where a gradient element nearly cancels, summation-
# order noise can move that element by up to lr: at 1e-4 that stays inside
# the 1e-5 bound on params of magnitude ~0.1 (at 1e-3 two embedding
# elements of 16k reach 3.5e-5).
LR = 1e-4


def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-12)
    err = np.abs(got - want).max() / scale
    assert err <= tol, (what, err)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _paths(tree[k], f"{prefix}/{k}")]
    return [prefix]


def _batch(seed, B=2, S=24, masked=False):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, TINY["vocab_size"], (B, S)).astype(
        np.int32)}
    if masked:
        mask = np.ones((B, S), np.float32)
        mask[0, 5:] = 0.0
        mask[1, :3] = 0.0
        batch["loss_mask"] = mask
    return batch


def _t_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _j_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def jax_params():
    return j_llama.init_params(J_CFG, jax.random.key(0))


def _port(tree):
    params = convert.params_from_numpy(jax.tree.map(np.asarray, tree),
                                       device="cpu")
    for t in tree_leaves(params):
        t.requires_grad_(True)
    return params


@pytest.fixture(scope="module")
def jax_value_and_grad():
    return {chunks: jax.jit(jax.value_and_grad(
        lambda p, b, c=J_CFG.replace(loss_chunks=chunks):
        j_llama.loss_fn(p, b, c)))
        for chunks in (0, 4)}


class TestLoss:
    @pytest.mark.parametrize("masked,chunks", [(False, 0), (True, 0),
                                               (True, 4)])
    def test_loss_and_every_gradient_match_jax(self, jax_params,
                                               jax_value_and_grad, masked,
                                               chunks):
        b = _batch(1, masked=masked)
        j_loss, j_grads = jax_value_and_grad[chunks](jax_params, _j_batch(b))
        params = _port(jax_params)
        cfg = T_CFG.replace(loss_chunks=chunks)
        loss = t_llama.loss_fn(params, _t_batch(b), cfg)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        assert loss.dtype == torch.float32 and loss.dim() == 0
        _close(_np(loss), _np(j_loss), F32, "loss")
        for path, g, jg in zip(_paths(j_grads), grads,
                               jax.tree.leaves(j_grads)):
            _close(_np(g), _np(jg), F32, path)

    def test_remat_modes_give_equal_gradients(self, jax_params):
        b = _t_batch(_batch(2))
        out = {}
        for remat in (False, True, "full", "mlp_only"):
            params = _port(jax_params)
            loss = t_llama.loss_fn(params, b, T_CFG.replace(remat=remat))
            out[remat] = [loss] + list(torch.autograd.grad(
                loss, tree_leaves(params)))
        for remat in (True, "full", "mlp_only"):
            for a, w in zip(out[remat], out[False]):
                torch.testing.assert_close(a, w, atol=1e-6, rtol=1e-6)

    @pytest.mark.parametrize("impl", ["reference", "flash"])
    @pytest.mark.parametrize("remat", ["dots", "dots_nobatch"])
    def test_dots_remat_matches_no_remat_and_jax(self, jax_params, remat,
                                                 impl):
        """Loss and every gradient under a selective remat policy equal remat
        False (fp32, 1e-6: the same products, saved or recomputed) and JAX's
        same policy (1e-5), with plain attention and the kernel path."""
        b = _batch(3, masked=True)
        out = {}
        for mode in (remat, False):
            params = _port(jax_params)
            loss = t_llama.loss_fn(params, _t_batch(b), T_CFG.replace(
                remat=mode, attention_impl=impl))
            out[mode] = [loss] + list(torch.autograd.grad(
                loss, tree_leaves(params)))
        for a, w in zip(out[remat], out[False]):
            torch.testing.assert_close(a, w, atol=1e-6, rtol=1e-6)
        j_loss, j_grads = jax.value_and_grad(
            lambda p: j_llama.loss_fn(p, _j_batch(b), J_CFG.replace(
                remat=remat)))(jax_params)
        _close(_np(out[remat][0]), _np(j_loss), F32, "loss")
        for path, g, jg in zip(_paths(j_grads), out[remat][1:],
                               jax.tree.leaves(j_grads)):
            _close(_np(g), _np(jg), F32, path)

    @pytest.mark.parametrize("impl", ["reference", "flash"])
    def test_dots_policies_save_the_products_jax_would(self, jax_params,
                                                       monkeypatch, impl):
        """What each policy saves, per layer.  Both save the seven
        projections (wq, wk, wv, wo, w_gate, w_up, w_down: einsum's
        batch-1 bmm).  "dots" also saves plain attention's two batched
        products (B * H batches); "dots_nobatch" does not.  On the card
        the kernel path's attention is one C entry that neither policy
        sees, so there both save the same set; on the CPU the kernels'
        plain stand-ins run inside ``_Flash`` and show as batched products
        here, which only "dots" saves."""
        saved = {}
        real = t_llama.remat_policy

        def recording(mode):
            inner = real(mode)

            def policy(ctx, op, *args, **kw):
                decision = inner(ctx, op, *args, **kw)
                if decision == t_llama.CheckpointPolicy.MUST_SAVE \
                        and not ctx.is_recompute:
                    batch = args[op is torch.ops.aten.baddbmm.default]
                    batch = batch.shape[0] if batch.dim() == 3 else 1
                    key = "plain" if batch == 1 else "batched"
                    saved[mode][key] = saved[mode].get(key, 0) + 1
                return decision
            return policy

        monkeypatch.setattr(t_llama, "remat_policy", recording)
        b = _t_batch(_batch(3))
        for mode in ("dots", "dots_nobatch"):
            saved[mode] = {}
            params = _port(jax_params)
            loss = t_llama.loss_fn(params, b, T_CFG.replace(
                remat=mode, attention_impl=impl))
            torch.autograd.grad(loss, tree_leaves(params))
        layers_ = TINY["layers"]
        for mode in ("dots", "dots_nobatch"):
            assert saved[mode]["plain"] == 7 * layers_, saved
        assert "batched" not in saved["dots_nobatch"], saved
        # reference: scores and probs @ v; the CPU stand-in of the flash
        # forward: those two and the LSE's scores.
        assert saved["dots"]["batched"] == (
            2 if impl == "reference" else 3) * layers_, saved

    def test_flash_interpret_equals_flash_and_jax(self, jax_params):
        """attention_impl="flash_interpret" (JAX: the Pallas kernels'
        bodies on the CPU) is the port's kernel path: equal to "flash", and
        to JAX's flash_interpret loss (fp32, 1e-5)."""
        b = _batch(4, masked=True)
        got = {}
        for impl in ("flash_interpret", "flash"):
            params = _port(jax_params)
            loss = t_llama.loss_fn(params, _t_batch(b),
                                   T_CFG.replace(attention_impl=impl))
            got[impl] = [loss] + list(torch.autograd.grad(
                loss, tree_leaves(params)))
        for a, w in zip(got["flash_interpret"], got["flash"]):
            assert torch.equal(a, w)
        want = j_llama.loss_fn(jax_params, _j_batch(b), J_CFG.replace(
            attention_impl="flash_interpret"))
        _close(_np(got["flash_interpret"][0]), _np(want), F32, "loss")

    def test_loss_chunks_must_divide_the_sequence(self, jax_params):
        with pytest.raises(ValueError, match="loss_chunks"):
            t_llama.loss_fn(_port(jax_params), _t_batch(_batch(3, S=10)),
                            T_CFG.replace(loss_chunks=4))

    def test_bf16_loss_matches_jax(self):
        jcfg = J_CFG.replace(dtype=jnp.bfloat16)
        jp = j_llama.init_params(jcfg, jax.random.key(1),
                                 param_dtype=jnp.bfloat16)
        b = _batch(4)
        want = float(j_llama.loss_fn(jp, _j_batch(b), jcfg))
        got = t_llama.loss_fn(_port(jp), _t_batch(b),
                              T_CFG.replace(dtype=torch.bfloat16))
        assert got.dtype == torch.float32
        assert abs(got.item() - want) <= 2e-2 * abs(want)


def _jax_trajectory(cfg, batches, n_steps):
    mesh = j_build_mesh(JMeshSpec(), devices=jax.devices()[:1])
    init_fn, step_fn, place = j_train_step(cfg, mesh, learning_rate=LR)
    params, opt = init_fn(jax.random.key(0))
    start = (jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, opt))
    metrics = []
    for i in range(n_steps):
        params, opt, m = step_fn(params, opt, place(_j_batch(batches[i])))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return start, metrics, (jax.tree.map(np.asarray, params),
                            jax.tree.map(np.asarray, opt))


@pytest.fixture(scope="module")
def jax_run():
    """Three adamw steps of the JAX package's make_lm_train_step on one
    device, flash attention in interpret mode, full remat."""
    cfg = J_CFG.replace(attention_impl="flash_interpret", remat=True)
    batches = [_batch(10 + i, B=4, S=32, masked=i == 1) for i in range(3)]
    return (batches,) + _jax_trajectory(cfg, batches, 3)


class TestTrainStep:
    def _port_step(self, **kw):
        mesh = build_mesh(MeshSpec(), device="cpu")
        cfg = T_CFG.replace(attention_impl="auto", remat=True)
        return make_lm_train_step(cfg, mesh, learning_rate=LR, **kw)

    def test_three_steps_match_jax(self, jax_run):
        batches, (p0, o0), j_metrics, (j_params, _o) = jax_run
        _init, step_fn, place = self._port_step()
        params = _port(p0)
        opt = convert.opt_state_from_numpy(o0, device="cpu")
        for i, b in enumerate(batches):
            params, opt, m = step_fn(params, opt, place(b))
            _close(float(m["loss"]), j_metrics[i][0], F32, f"loss {i}")
            _close(float(m["grad_norm"]), j_metrics[i][1], F32,
                   f"grad_norm {i}")
        assert int(opt.count) == 3 and opt.count.dtype == torch.int32
        for path, p, jp in zip(_paths(j_params), tree_leaves(params),
                               jax.tree.leaves(j_params)):
            _close(_np(p), jp, F32, path)

    def test_opt_state_carried_over_continues_the_jax_run(self, jax_run):
        """Params and adamw state after JAX's three steps, carried over:
        one more step on each side agrees."""
        batches, _start, _m, (j_params, j_opt) = jax_run
        cfg = J_CFG.replace(attention_impl="flash_interpret", remat=True)
        mesh = j_build_mesh(JMeshSpec(), devices=jax.devices()[:1])
        _i, j_step, j_place = j_train_step(cfg, mesh, learning_rate=LR)
        b = _batch(20, B=4, S=32)
        opt = convert.opt_state_from_numpy(j_opt, device="cpu")
        assert int(opt.count) == 3
        for path, mu, jmu in zip(_paths(j_params), tree_leaves(opt.mu),
                                 jax.tree.leaves(j_opt[0].mu)):
            np.testing.assert_array_equal(_np(mu), jmu, err_msg=path)
        params = _port(j_params)
        jp, _jo, jm = j_step(jax.tree.map(jnp.asarray, j_params),
                             jax.tree.map(jnp.asarray, j_opt), j_place(
                                 _j_batch(b)))
        _init, step_fn, place = self._port_step()
        params, opt, m = step_fn(params, opt, place(b))
        _close(float(m["loss"]), float(jm["loss"]), F32, "loss")
        for path, p, w in zip(_paths(j_params), tree_leaves(params),
                              jax.tree.leaves(jp)):
            _close(_np(p), _np(w), F32, path)

    def test_grad_accum_equals_one_step_with_uneven_masking(self):
        """grad_accum is a pure memory trade: every microbatch normalises by
        the full batch's token count (tests/test_models.py:184)."""
        rng = np.random.default_rng(0)
        b = {"tokens": rng.integers(0, 256, (8, 32)).astype(np.int32),
             "loss_mask": np.ones((8, 32), np.float32)}
        b["loss_mask"][:2, 10:] = 0.0
        out = []
        for accum in (1, 4):
            init_fn, step_fn, place = self._port_step(grad_accum=accum)
            params, opt = init_fn(torch.Generator().manual_seed(0))
            for _ in range(3):
                params, opt, m = step_fn(params, opt, place(b))
            out.append((float(m["loss"]), float(m["grad_norm"]),
                        tree_leaves(params)))
        assert abs(out[0][0] - out[1][0]) <= 1e-5 * out[0][0]
        assert abs(out[0][1] - out[1][1]) <= 1e-5 * out[0][1]
        for a, w in zip(out[1][2], out[0][2]):
            _close(_np(a), _np(w), F32)

    def test_donate_false_leaves_the_inputs_alone(self):
        init_fn, step_fn, place = self._port_step(donate=False)
        params, opt = init_fn(torch.Generator().manual_seed(1))
        before = [t.detach().clone() for t in tree_leaves(params)]
        new, new_opt, _m = step_fn(params, opt, place(_batch(5)))
        assert int(opt.count) == 0 and int(new_opt.count) == 1
        for t, b in zip(tree_leaves(params), before):
            assert torch.equal(t, b)
        assert any(not torch.equal(t, b)
                   for t, b in zip(tree_leaves(new), before))

    def test_init_and_eval_step(self):
        init_fn, _step, place = self._port_step(param_dtype=torch.bfloat16)
        params, opt = init_fn(torch.Generator().manual_seed(2))
        leaves = tree_leaves(params)
        assert all(t.dtype == torch.bfloat16 and t.requires_grad
                   for t in leaves)
        assert all(m.dtype == torch.bfloat16 and not m.requires_grad
                   for m in tree_leaves(opt.mu) + tree_leaves(opt.nu))
        assert sum(t.numel() for t in leaves) == t_llama.num_params(T_CFG)
        eval_step = make_lm_eval_step(T_CFG, build_mesh(device="cpu"))
        b = place(_batch(6))
        loss = eval_step(params, b)
        assert loss.grad_fn is None
        with_graph = t_llama.loss_fn(params, b, T_CFG)
        assert with_graph.grad_fn is not None
        assert loss.item() == pytest.approx(with_graph.item(), rel=1e-6)


class TestOptim:
    def test_adamw_matches_optax(self):
        import optax
        rng = np.random.default_rng(7)
        params = {"w": rng.standard_normal((5, 3)).astype(np.float32),
                  "b": {"x": rng.standard_normal(4).astype(np.float32)}}
        j_opt = optax.adamw(1e-2, b1=0.9, b2=0.95, weight_decay=0.1)
        jp = jax.tree.map(jnp.asarray, params)
        js = j_opt.init(jp)
        t_opt = optim.adamw(1e-2, b1=0.9, b2=0.95, weight_decay=0.1)
        tp = {"w": torch.from_numpy(params["w"].copy()),
              "b": {"x": torch.from_numpy(params["b"]["x"].copy())}}
        ts = t_opt.init(tp)
        for step in range(4):
            g = {"w": rng.standard_normal((5, 3)).astype(np.float32),
                 "b": {"x": rng.standard_normal(4).astype(np.float32)}}
            u, js = j_opt.update(jax.tree.map(jnp.asarray, g), js, jp)
            jp = optax.apply_updates(jp, u)
            _close(_np(optim.global_norm(jax.tree.map(torch.from_numpy, g))),
                   optax.global_norm(g), 1e-6, "global_norm")
            ts = t_opt.update(jax.tree.map(torch.from_numpy, g), ts, tp)
            for a, w in zip(tree_leaves(tp), jax.tree.leaves(jp)):
                _close(_np(a), _np(w), 1e-6, f"step {step}")
        assert int(ts.count) == 4

    @pytest.mark.parametrize("name", ["adam", "adamw_warmup",
                                      "adam_warmup"])
    def test_optax_shaped_updates_match(self, name):
        """The step's optimizers alone against optax on random gradients,
        past the warmup: the in-place adamw on a schedule, and the
        functional chains (``update`` then ``apply_updates``), whose state
        keeps optax's layout (a ``ScaleByScheduleState`` for a
        schedule)."""
        import optax
        t_opt, j_opt = _optimizers(name)
        rng = np.random.default_rng(8)
        params = {"w": rng.standard_normal((5, 3)).astype(np.float32),
                  "b": {"x": rng.standard_normal(4).astype(np.float32)}}
        jp = jax.tree.map(jnp.asarray, params)
        js = j_opt.init(jp)
        tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), params)
        ts = t_opt.init(tp)
        for step in range(WARMUP + 2):
            g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
                np.float32), params)
            u, js = j_opt.update(jax.tree.map(jnp.asarray, g), js, jp)
            jp = optax.apply_updates(jp, u)
            tg = jax.tree.map(torch.from_numpy, g)
            if isinstance(t_opt, optim.AdamW):
                ts = t_opt.update(tg, ts, tp)
            else:
                tu, ts = t_opt.update(tg, ts, tp)
                tp = optim.apply_updates(tp, tu)
            for a, w in zip(tree_leaves(tp), jax.tree.leaves(jp)):
                _close(_np(a), _np(w), 1e-6, f"step {step}")
        if not isinstance(t_opt, optim.AdamW):
            conv = convert.optax_state_from_numpy(
                jax.tree.map(np.asarray, js), device="cpu")
            assert str(tree_map(lambda t: 0, ts)) == str(
                tree_map(lambda t: 0, conv))
            for a, w in zip(tree_leaves(ts), tree_leaves(conv)):
                np.testing.assert_array_equal(_np(a), _np(w))


# The optax-shaped optimizers the step takes beside the in-place adamw: the
# port's and optax's, by name, with a warmup schedule (a callable of the
# step count) for adamw.
WARMUP = 2


def _t_warmup(count):
    return LR / 4 + (LR - LR / 4) * min(count, WARMUP) / WARMUP


def _optimizers(name):
    """(port optimizer, optax optimizer) called ``name``."""
    import optax
    if name == "adam":
        return optim.adam(LR), optax.adam(LR)
    if name == "adamw_warmup":
        return (optim.adamw(_t_warmup, b1=0.9, b2=0.95, weight_decay=0.1),
                optax.adamw(optax.linear_schedule(LR / 4, LR, WARMUP),
                            b1=0.9, b2=0.95, weight_decay=0.1))
    if name == "adam_warmup":
        return (optim.adam(_t_warmup),
                optax.adam(optax.linear_schedule(LR / 4, LR, WARMUP)))
    raise ValueError(name)


@pytest.mark.parametrize("name", ["adam", "adamw_warmup", "adam_warmup"])
def test_step_takes_optax_optimizers_as_jax(jax_params, name):
    """make_lm_train_step(optimizer=...) on one device with an optax-shaped
    transformation (functional update, then apply_updates) or adamw on a
    schedule: three steps from JAX's weights (two of warmup, one at the
    peak) match JAX's step given the optax counterpart (fp32, 1e-5 of each
    leaf's scale, as the three adamw steps above)."""
    t_opt, j_opt = _optimizers(name)
    mesh = j_build_mesh(JMeshSpec(), devices=jax.devices()[:1])
    _i, j_step, j_place = j_train_step(J_CFG, mesh, optimizer=j_opt)
    # JAX's step donates its inputs: it gets a copy of the shared weights.
    jp = jax.tree.map(jnp.array, jax_params)
    js = j_opt.init(jp)
    _i, step_fn, place = make_lm_train_step(
        T_CFG, build_mesh(MeshSpec(), device="cpu"), optimizer=t_opt)
    params = _port(jax_params)
    state = t_opt.init(params)
    for i in range(WARMUP + 1):
        b = _batch(30 + i, B=4, S=32)
        jp, js, jm = j_step(jp, js, j_place(_j_batch(b)))
        params, state, m = step_fn(params, state, place(b))
        _close(float(m["loss"]), float(jm["loss"]), F32, f"loss {i}")
        _close(float(m["grad_norm"]), float(jm["grad_norm"]), F32,
               f"grad_norm {i}")
    assert all(t.requires_grad for t in tree_leaves(params))
    # Params relative to the whole tree's scale, as the RL parity tests
    # hold them: Adam turns last-bit gradient differences of a nearly
    # cancelling element into a few percent of its lr-sized step (an
    # embedding element ~0.1 lands 3e-6 apart after three steps here; the
    # optimizers alone agree to 1e-6, test_optax_shaped_updates_match).
    scale = max(np.abs(_np(w)).max() for w in jax.tree.leaves(jp))
    for path, p, w in zip(_paths(jp), tree_leaves(params),
                          jax.tree.leaves(jp)):
        err = np.abs(_np(p) - _np(w)).max() / scale
        assert err <= F32, (path, err)
    # The state carries optax's layout, so JAX's converts node for node
    # (the in-place adamw keeps only its (count, mu, nu)).
    conv = convert.optax_state_from_numpy(jax.tree.map(np.asarray, js),
                                          device="cpu")
    if isinstance(t_opt, optim.AdamW):
        conv = optim.from_optax_state(conv)
    assert str(tree_map(lambda t: 0, state)) == str(tree_map(lambda t: 0,
                                                             conv))
    for a, w in zip(tree_leaves(state), tree_leaves(conv)):
        _close(_np(a), _np(w), F32)


def test_multi_device_mesh_raises():
    """Without a torch.distributed world there is one rank: a spec that
    needs more devices, or does not resolve, raises ValueError."""
    mesh = build_mesh(MeshSpec(dp=-1), device="cpu")
    assert mesh.spec == MeshSpec() and mesh.device == torch.device("cpu")
    assert mesh.device_mesh is None
    for spec in (MeshSpec(dp=-1, tp=-1), MeshSpec(sp=0), MeshSpec(dp=2),
                 MeshSpec(fsdp=8), MeshSpec(tp=2, sp=2),
                 MeshSpec(num_slices=2)):
        with pytest.raises(ValueError):
            build_mesh(spec, device="cpu")
