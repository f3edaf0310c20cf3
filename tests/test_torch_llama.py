"""ray_tpu_torch.models against ray_tpu.models, on the CPU.

The JAX parameters carry over through ``params_from_numpy``; the forward
logits must agree at 1e-4 in fp32, and in bf16 within 2e-2 of the logits'
largest magnitude (bf16 runs build the JAX params with
``param_dtype=bfloat16`` so both sides hold the same weights).  The bf16
bound is scaled because JAX's bf16 SiLU rounds differently from torch's (an
ulp apart on many inputs), which moves single logits by a little more than
2e-2 absolute after two layers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ray_tpu.models import llama as j_llama
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import llama as t_llama

TINY = dict(vocab_size=256, hidden=64, layers=2, heads=4, kv_heads=2,
            head_dim=16, mlp_dim=128, max_seq_len=64)
J_CFG = j_llama.LlamaConfig(**TINY, dtype=jnp.float32, remat=False,
                            attention_impl="reference")
T_CFG = t_llama.LlamaConfig(**TINY, dtype=torch.float32)


@pytest.fixture(scope="module")
def jax_params():
    return j_llama.init_params(J_CFG, jax.random.key(0))


@pytest.fixture(scope="module")
def port_params(jax_params):
    return convert.params_from_numpy(jax.tree.map(np.asarray, jax_params),
                                     device="cpu")


def assert_bf16_close(got, want):
    err = np.abs(got - want).max()
    assert err <= 2e-2 * np.abs(want).max(), (err, np.abs(want).max())


def _tokens(seed, B, S):
    return np.random.default_rng(seed).integers(0, TINY["vocab_size"],
                                                size=(B, S))


class TestForward:
    @pytest.mark.parametrize("attention_impl", ["auto", "reference",
                                                "flash_interpret"])
    def test_logits_match_jax_fp32(self, jax_params, port_params,
                                   attention_impl):
        toks = _tokens(0, 2, 24)
        want = np.asarray(j_llama.forward(jax_params, jnp.asarray(toks),
                                          J_CFG))
        cfg = T_CFG.replace(attention_impl=attention_impl)
        got = t_llama.forward(port_params, torch.from_numpy(toks), cfg)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)

    def test_explicit_positions(self, jax_params, port_params):
        toks = _tokens(1, 1, 12)
        pos = np.arange(12) + 20
        want = np.asarray(j_llama.forward(jax_params, jnp.asarray(toks),
                                          J_CFG, jnp.asarray(pos)))
        got = t_llama.forward(port_params, torch.from_numpy(toks), T_CFG,
                              torch.from_numpy(pos))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)

    def test_logits_match_jax_bf16(self):
        jcfg = J_CFG.replace(dtype=jnp.bfloat16)
        jp = j_llama.init_params(jcfg, jax.random.key(1),
                                 param_dtype=jnp.bfloat16)
        tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                       device="cpu")
        assert tp["blocks"]["wq"].dtype == torch.bfloat16
        toks = _tokens(2, 1, 16)
        want = np.asarray(j_llama.forward(jp, jnp.asarray(toks), jcfg))
        got = t_llama.forward(tp, torch.from_numpy(toks),
                              T_CFG.replace(dtype=torch.bfloat16))
        assert got.dtype == torch.float32
        assert_bf16_close(got.numpy(), want)

    def test_aux_is_zero_for_dense(self, port_params):
        _logits, aux = t_llama.forward_with_aux(
            port_params, torch.from_numpy(_tokens(3, 1, 4)), T_CFG)
        assert float(aux) == 0.0


class TestConfig:
    @pytest.mark.parametrize("name", ["llama_tiny", "llama_125m",
                                      "llama_1b", "llama_7b"])
    def test_presets_and_num_params_match_jax(self, name):
        j_cfg = getattr(j_llama, name)()
        t_cfg = getattr(t_llama, name)()
        for f in dataclasses.fields(j_cfg):
            if f.name != "dtype":
                assert getattr(t_cfg, f.name) == getattr(j_cfg, f.name), \
                    f.name
        assert t_cfg.dtype == torch.bfloat16
        assert t_llama.num_params(t_cfg) == j_llama.num_params(j_cfg)

    @pytest.mark.parametrize("change", [
        dict(pp_microbatches=2),
        dict(pp_microbatches=2, num_experts=4),
        dict(pp_microbatches=2, attention_impl="ring"),
        dict(pp_microbatches=2, attention_impl="ulysses")])
    def test_unsupported_configs_raise(self, jax_params, port_params, change):
        """The JAX model's own refusals, with the same conditions: a
        pipeline without a pp > 1 mesh, and MoE or sequence-parallel
        attention inside a pipeline (given a pp mesh)."""
        from ray_tpu.parallel import MeshSpec, build_mesh
        from ray_tpu.parallel.mesh import set_global_mesh
        no_mesh = change == dict(pp_microbatches=2)
        j_cfg = J_CFG.replace(**change)
        j_params = (j_llama.init_params(j_cfg, jax.random.key(0))
                    if j_cfg.num_experts else jax_params)
        set_global_mesh(None if no_mesh else build_mesh(
            MeshSpec(pp=2), devices=jax.devices()[:2]))
        try:
            with pytest.raises((ValueError, NotImplementedError)) as want:
                j_llama.forward(j_params, jnp.zeros((2, 4), jnp.int32),
                                j_cfg)
        finally:
            set_global_mesh(None)
        t_cfg = T_CFG.replace(**change)
        t_params = (convert.params_from_numpy(
            jax.tree.map(np.asarray, j_params), device="cpu")
            if t_cfg.num_experts else port_params)
        # The refusals come before the pp group is used.
        groups = t_llama.ParallelGroups(pp=None if no_mesh else object())
        with t_llama.parallel_groups(groups), \
                pytest.raises(want.type) as got:
            t_llama.forward(t_params, torch.zeros(2, 4, dtype=torch.long),
                            t_cfg)
        assert str(got.value) == str(want.value)

    @pytest.mark.parametrize("head_dim,impl,device,ok", [
        (32, "auto", "cuda", True), (64, "flash", "cuda", True),
        (128, "flash_interpret", "cuda", True),
        (16, "auto", "cuda", False), (80, "flash", "cuda", False),
        (16, "reference", "cuda", True), (16, "auto", "cpu", True)])
    def test_card_refuses_head_dims_its_kernels_do_not_take(
            self, head_dim, impl, device, ok):
        """Refused when an engine or a step is built, never at the first
        kernel call, with the way out named."""
        cfg = T_CFG.replace(head_dim=head_dim, attention_impl=impl)
        if ok:
            t_llama.check_device_supported(cfg, torch.device(device))
            return
        with pytest.raises(ValueError, match='attention_impl="reference"'):
            t_llama.check_device_supported(cfg, torch.device(device))

    def test_logical_axes_tree_matches_params_and_jax(self, port_params):
        logical = t_llama.param_logical_axes(T_CFG)
        assert logical == j_llama.param_logical_axes(J_CFG)
        for name, t in port_params["blocks"].items():
            assert t.dim() == len(logical["blocks"][name]), name
        for name in ("embed", "final_norm", "lm_head"):
            assert port_params[name].dim() == len(logical[name]), name


class TestInitParams:
    def test_shapes_match_jax(self, jax_params):
        tp = t_llama.init_params(T_CFG, torch.Generator().manual_seed(0),
                                 device="cpu")
        jshapes = jax.tree.map(lambda a: tuple(a.shape), jax_params)
        tshapes = {k: ({kk: tuple(vv.shape) for kk, vv in v.items()}
                       if isinstance(v, dict) else tuple(v.shape))
                   for k, v in tp.items()}
        assert tshapes == jshapes
        total = sum(t.numel() for t in tp["blocks"].values()) + sum(
            tp[k].numel() for k in ("embed", "final_norm", "lm_head"))
        assert total == t_llama.num_params(T_CFG)

    def test_truncated_normal_scale(self):
        cfg = T_CFG.replace(hidden=256, mlp_dim=512)
        tp = t_llama.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
        w = tp["blocks"]["w_gate"] * 256 ** 0.5   # fan_in = hidden
        assert float(w.abs().max()) <= 2.0 + 1e-6
        # std of N(0,1) truncated to [-2, 2] is 0.8796
        assert abs(float(w.std()) - 0.8796) < 0.01
        assert torch.equal(tp["blocks"]["attn_norm"],
                           torch.ones_like(tp["blocks"]["attn_norm"]))

    def test_seeded_and_typed(self):
        a = t_llama.init_params(T_CFG, torch.Generator().manual_seed(5),
                                param_dtype=torch.bfloat16, device="cpu")
        b = t_llama.init_params(T_CFG, torch.Generator().manual_seed(5),
                                param_dtype=torch.bfloat16, device="cpu")
        assert a["embed"].dtype == torch.bfloat16
        assert torch.equal(a["lm_head"], b["lm_head"])

    def test_default_device_needs_a_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t_llama.init_params(T_CFG, torch.Generator().manual_seed(0))


class TestConvert:
    def test_layout_kept_without_transposes(self, jax_params, port_params):
        for k in ("wq", "wk", "wo", "w_down"):
            np.testing.assert_array_equal(
                port_params["blocks"][k].numpy(),
                np.asarray(jax_params["blocks"][k]))
        np.testing.assert_array_equal(port_params["lm_head"].numpy(),
                                      np.asarray(jax_params["lm_head"]))

    def test_bf16_leaves_and_cast(self):
        a = jnp.asarray(np.linspace(-3, 3, 12, dtype=np.float32)).astype(
            jnp.bfloat16).reshape(3, 4)
        got = convert.params_from_numpy({"x": [a]}, device="cpu")["x"][0]
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(a.astype(jnp.float32)))
        cast = convert.params_from_numpy({"x": a}, dtype=torch.float32,
                                         device="cpu")["x"]
        assert cast.dtype == torch.float32
