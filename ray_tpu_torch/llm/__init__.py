"""ray_tpu_torch.llm — LLM serving and batch inference on the card.

Counterpart of ray_tpu/llm: a paged KV cache, continuous-batching decode
over all active slots through the paged decode kernel, and length-bucketed
prefill through the flash forward kernel, driven directly
(``InferenceEngine.generate``, ``run_pipelined``) or behind ``LLMServer``.
"""

from ._cache import PagePool
from .engine import InferenceEngine, Request, SamplingParams, sample_logits
from .serving import LLMServer, build_llm_deployment

__all__ = [
    "InferenceEngine", "SamplingParams", "Request", "PagePool",
    "LLMServer", "build_llm_deployment", "sample_logits",
]
