"""The port's serve deployments (``ray_tpu_torch.serve``) against the JAX
package, on the CPU.

``build_llm_deployment`` with ``llama_tiny`` (fp32) on JAX's weights
(``params_from_numpy`` inside the replica process): greedy tokens through
``remote`` (several requests at once) and through the stream
(``options(stream=True, method_name="stream")``) equal JAX's full forward
re-run per token (the gold of tests/test_llm.py's
``test_serve_deployment_end_to_end``).  ``build_disagg_deployment`` gets the
same check, one ``DisaggServer`` a replica.  A small deployment then holds
the handle's routing: least requests in flight, the ``max_queued_requests``
shed as ``OverloadError``, ``status``, ``get_deployment_handle``, replacing
a deployment, and ``shutdown`` ending the replica processes; what is
still refused (gRPC, per-node proxies, node-drain evacuation) names
ROADMAP items 6c and 3(c).  The serve controller, batching, multiplexing
and the HTTP ingress: tests/test_torch_serve_ctl.py.

Replicas run torch on one thread; every ``get`` has a timeout.  JAX is
imported inside functions: each replica imports this file to find
``_tiny_params``.
"""

from __future__ import annotations

import functools
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from ray_tpu_torch import _actor as A
from ray_tpu_torch import serve

ONE_THREAD = {"num_cpus": 1, "env_vars": {"OMP_NUM_THREADS": "1"}}
ENGINE = {"device": "cpu", "max_slots": 4, "page_size": 8, "num_pages": 96,
          "prefill_buckets": (16,)}
PROMPTS = [[3, 17, 92, 5, 41], [7, 9, 23, 6], [100, 2, 57, 8, 9, 11]]
NEW = 6


def _tiny_params(params_np):
    """The replica's ``build_params``: JAX's numpy weights -> the port's
    tensors, with the port's llama_tiny config in fp32."""
    import torch

    from ray_tpu_torch.models import convert
    from ray_tpu_torch.models import llama as t_llama
    cfg = t_llama.llama_tiny().replace(dtype=torch.float32)
    return convert.params_from_numpy(params_np, device="cpu"), cfg


@pytest.fixture(scope="module")
def gold():
    """JAX's llama_tiny weights (numpy) and its greedy tokens for
    ``PROMPTS``: the full forward re-run per token."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import llama as j_llama
    cfg = j_llama.llama_tiny().replace(dtype=jnp.float32, remat=False,
                                       attention_impl="reference")
    params = j_llama.init_params(cfg, jax.random.key(0))
    fwd = jax.jit(lambda p, t: j_llama.forward(p, t, cfg))
    want = []
    for prompt in PROMPTS:
        toks = list(prompt)
        for _ in range(NEW):
            logits = fwd(params, jnp.asarray([toks]))
            toks.append(int(jnp.argmax(logits[0, len(toks) - 1])))
        want.append(toks[len(prompt):])
    return jax.tree.map(np.asarray, params), want


@pytest.fixture(scope="module")
def handles(gold):
    """The LLM and the disagg deployment, started together."""
    from ray_tpu_torch.llm import build_llm_deployment
    from ray_tpu_torch.llm.disagg import build_disagg_deployment
    build = functools.partial(_tiny_params, gold[0])
    apps = [
        build_llm_deployment(build, name="tiny_llm", engine_options=ENGINE),
        build_disagg_deployment(build, name="tiny_disagg", mode="disagg",
                                engine_options=ENGINE)]
    apps = [serve.Application(a.deployment.options(
        ray_actor_options=ONE_THREAD)) for a in apps]
    with ThreadPoolExecutor(2) as pool:
        hs = list(pool.map(serve.run, apps))
    yield dict(zip(("llm", "disagg"), hs))
    serve.shutdown()


def _body(prompt):
    return {"prompt_tokens": prompt, "max_tokens": NEW}


@pytest.mark.parametrize("name", ["llm", "disagg"])
def test_deployment_greedy_equals_jax(handles, gold, name):
    h = handles[name]
    refs = [h.remote(_body(p)) for p in PROMPTS]
    outs = A.get(refs, timeout=120)
    assert [o["output_tokens"] for o in outs] == gold[1]
    assert all(o["finish_reason"] == "length" for o in outs)
    assert serve.status()[f"tiny_{name}"]["num_replicas"] == 1


def test_llm_stream_and_methods_equal_jax(handles, gold):
    h = handles["llm"]
    gen = h.options(stream=True, method_name="stream").remote(
        _body(PROMPTS[0]))
    items = [A.get(r, timeout=120) for r in gen]
    assert [it["token"] for it in items if "token" in it] == gold[1][0]
    assert items[-1] == {"finish_reason": "length", "num_tokens": NEW}
    batch = h.options(method_name="generate_batch").remote(
        PROMPTS, max_tokens=NEW)
    assert A.get(batch, timeout=120) == gold[1]
    same = serve.get_deployment_handle("tiny_llm")
    assert A.get(same.remote(_body(PROMPTS[1])),
                 timeout=120)["output_tokens"] == gold[1][1]


class Sleeper:
    """A deployment of the routing tests."""

    def __init__(self, tag):
        self.tag = tag

    def __call__(self, seconds):
        time.sleep(seconds)
        return self.tag

    def pid(self):
        import os
        return os.getpid()

    def shutdown(self):
        pass


def test_routing_shed_status_and_shutdown():
    dep = serve.deployment(Sleeper, name="sleeper", num_replicas=2,
                           max_ongoing_requests=1, max_queued_requests=0,
                           ray_actor_options=ONE_THREAD)
    h = serve.run(dep.bind("a"))
    pids = A.get([h.pid.remote() for _ in range(2)], timeout=120)
    # Least in flight: two requests at once land on both replicas.
    assert len(set(pids)) == 2
    slow = [h.remote(1.0) for _ in range(2)]
    # Capacity (2 replicas x 1) reached, no queue allowance: shed.
    with pytest.raises(serve.OverloadError):
        h.remote(0.0)
    st = serve.status()["sleeper"]
    assert st["num_replicas"] == 2 and sum(st["inflight"].values()) == 2
    assert A.get(slow, timeout=60) == ["a", "a"]
    assert A.get(h.remote(0.0), timeout=60) == "a"
    # Redeploying under the name replaces the replicas.
    h = serve.run(dep.options(num_replicas=1).bind("b"))
    assert A.get(h.remote(0.0), timeout=120) == "b"
    assert serve.status()["sleeper"]["num_replicas"] == 1
    procs = [A._started_proc(r._actor_id)
             for r in serve.api._state("sleeper").replicas]
    serve.shutdown()
    assert serve.status() == {}
    assert all(p.exitcode is not None for p in procs)
    with pytest.raises(ValueError, match="no deployment"):
        serve.get_deployment_handle("sleeper")


def test_refusals_name_item_6b(gold):
    """Item 6b is done; what it left refused names items 6c and 3(c)."""
    from ray_tpu_torch.llm import build_llm_deployment
    from ray_tpu_torch.serve import proxy
    from ray_tpu_torch.serve.controller import ServeController
    with pytest.raises(TypeError, match="AutoscalingConfig"):
        build_llm_deployment(_tiny_params, autoscaling_config=object())
    for call in (lambda: serve.add_grpc_service("svc"),
                 lambda: serve.remove_grpc_service("svc"),
                 proxy.start_node_proxies, proxy.stop_node_proxies):
        with pytest.raises(NotImplementedError, match="item 6c"):
            call()
    with pytest.raises(NotImplementedError, match=r"item 3\(c\)"):
        ServeController._evacuate_draining(None, None, {"node"})
    # A lambda build_params cannot reach a replica process.
    with pytest.raises(ValueError, match="top level of a module"):
        serve.run(build_llm_deployment(lambda: None, name="lam"))
    assert "lam" not in serve.status()
