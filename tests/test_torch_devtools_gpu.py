"""The developer tools on the card: the host-sync tripwire, a
``torch.profiler`` capture in a CUDA actor, and a CUDA tensor crossing a
compiled DAG channel.

Marked ``gpu``: without a CUDA device every test here skips, decided in
the ``cuda`` fixture (never at import: workers must collect the same
tests whether or not they see a card).  On the card::

    python -m pytest -m gpu tests/test_torch_devtools_gpu.py -q
"""

from __future__ import annotations

import os
import sys
import time

import pytest
import torch

from ray_tpu_torch import _actor as A

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels run only there)")
    return torch.device("cuda")


def _tiny(device="cuda"):
    from ray_tpu_torch.models.llama import init_params, llama_tiny
    cfg = llama_tiny().replace(dtype=torch.bfloat16)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         param_dtype=torch.bfloat16, device=device)
    return params, cfg


def _chunk_inputs(cfg, P=4):
    kv = tuple(torch.zeros((P + 1, 16, 2 * cfg.kv_heads, cfg.head_dim),
                           dtype=cfg.dtype, device="cuda")
               for _ in range(cfg.layers))
    bt = torch.arange(1, P + 1, dtype=torch.int32, device="cuda")[None]
    tok = torch.tensor([5], dtype=torch.int32, device="cuda")
    pos = torch.tensor([20], dtype=torch.int32, device="cuda")
    active = torch.ones(1, dtype=torch.bool, device="cuda")
    return kv, bt, tok, pos, active


@pytest.fixture
def tripwire():
    from ray_tpu_torch.devtools import syncdebug
    syncdebug.clear()
    syncdebug.install()
    yield syncdebug
    syncdebug.uninstall()
    syncdebug.clear()


def test_item_on_a_cuda_tensor_is_counted(cuda, tripwire):
    x = torch.arange(6, dtype=torch.float32, device=cuda)
    vals = [x[i].item() for i in range(6)]
    line = sys._getframe().f_lineno - 1
    assert vals == [0.0, 1.0, 2.0, 3.0, 4.0, 5.0]
    x.cpu().tolist()                      # a CPU tensor: not counted
    (row,) = tripwire.report()["sites"]
    assert (row["site"], row["kind"], row["count"]) == (
        f"test_torch_devtools_gpu.py:{line}", "item", 6)


def test_decode_chunk_and_engine_count_no_sync(cuda, tripwire):
    from ray_tpu_torch.llm import InferenceEngine, SamplingParams, _model
    params, cfg = _tiny()
    kv, bt, tok, pos, active = _chunk_inputs(cfg)
    gen = torch.Generator(device="cuda").manual_seed(1)
    _model.decode_chunk(params, kv, tok, pos, bt, active, gen, cfg, 16, 8,
                        0.0, 0)
    torch.cuda.synchronize()
    tripwire.clear()
    out, _p, _kv = _model.decode_chunk(params, kv, tok, pos, bt, active,
                                       gen, cfg, 16, 8, 0.0, 0)
    assert tripwire.report()["total_syncs"] == 0
    out.cpu()                            # the readback: .cpu(), unseen
    eng = InferenceEngine(params, cfg, device="cuda", max_slots=4,
                          page_size=16, num_pages=64, prefill_buckets=(64,))
    tripwire.clear()
    eng.generate([[1, 2, 3, 4, 5]] * 3, SamplingParams(max_tokens=24))
    assert tripwire.report()["total_syncs"] == 0, tripwire.report()


class DecodeActor:
    """Decodes llama_tiny chunks on the card for a given time (module
    level: the actor imports this file)."""

    def __init__(self):
        self.params, self.cfg = _tiny()

    def run(self, seconds):
        from ray_tpu_torch.llm import _model
        kv, bt, tok, pos, active = _chunk_inputs(self.cfg)
        gen = torch.Generator(device="cuda").manual_seed(1)
        n, t0 = 0, time.monotonic()
        while time.monotonic() - t0 < seconds:
            _model.decode_chunk(self.params, kv, tok, pos, bt, active, gen,
                                self.cfg, 16, 8, 0.0, 0)
            torch.cuda.synchronize()
            n += 1
        return n

    def pid(self):
        return os.getpid()


def test_profile_of_a_cuda_actor_names_paged_decode(cuda, tmp_path):
    from ray_tpu_torch import profiler
    from ray_tpu_torch.ops import _build
    _build.build()
    actor = A.remote(DecodeActor).remote()
    try:
        pid = A.get(actor.pid.remote(), timeout=300)
        A.get(actor.run.remote(0.5), timeout=300)        # warm
        # Busy well past the window: a process's first torch.profiler
        # window starts seconds after the call (CUPTI's setup).
        busy = actor.run.remote(20.0)
        time.sleep(0.5)
        res = profiler.profile(duration_s=1.5, torch_profile=True,
                               profile_dir=str(tmp_path))
        assert A.get(busy, timeout=120) > 0
    finally:
        A.kill(actor)
    assert res["unresponsive"] == []
    names = {e["name"] for e in res["trace"]["traceEvents"]
             if e.get("cat") == "kernel"
             and str(e.get("pid", "")).endswith(f"pid={pid}")}
    procs = res["trace"]["otherData"]["processes"]
    assert any("paged_decode" in n for n in names), (sorted(names)[:20],
                                                     procs)


class TensorNode:
    """Makes and receives CUDA tensors (module level: the actor imports
    this file)."""

    def make(self, seed):
        g = torch.Generator(device="cuda").manual_seed(int(seed))
        return torch.randn(1 << 16, generator=g, device="cuda")

    def recv(self, t):
        return (t.device.type, float(t.double().sum()), t.cpu().numpy())


def test_cuda_tensor_crosses_a_dag_channel_by_value(cuda):
    import numpy as np

    from ray_tpu_torch.dag import InputNode
    from ray_tpu_torch.dag.compiled_dag import pack_payload
    a, b = (A.remote(TensorNode).remote() for _ in range(2))
    try:
        with InputNode() as inp:
            dag = b.recv.bind(a.make.bind(inp))
        compiled = dag.experimental_compile(buffer_size_bytes=1 << 20)
        try:
            for seed in (3, 4):
                kind, total, host = compiled.execute(seed).get(timeout=120)
                want = TensorNode().make(seed)
                assert kind == "cuda"
                np.testing.assert_array_equal(host, want.cpu().numpy())
                assert total == float(want.double().sum())
        finally:
            compiled.teardown()
    finally:
        A.kill(a)
        A.kill(b)
    # By value through the host: the payload holds the tensor's bytes.
    t = torch.ones(1 << 16, device="cuda")
    assert len(pack_payload(t)) >= t.numel() * t.element_size()
