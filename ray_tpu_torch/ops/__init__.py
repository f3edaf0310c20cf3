"""Ops layer of the port: plain PyTorch building blocks and the hand-written
Hopper kernels of the serving and training paths.

- ``norms``/``rope``   — plain PyTorch (the JAX package leaves them to XLA)
- ``attention``        — causal (GQA) attention: CUDA flash forward
                         (``csrc/flash_fwd.cu``) and backward
                         (``csrc/flash_bwd.cu``), and their plain versions
- ``paged_attention``  — decode attention over the paged KV cache: CUDA
                         paged decode (``csrc/paged_decode.cu``) and its plain
                         version
- ``ring_attention``   — context parallelism: K/V blocks around the sp ring,
                         each step on the flash kernels, merged by LSE
- ``ulysses``          — sequence parallelism by all-to-all between the head
                         and sequence splits, the flash kernels in between
- ``moe``              — top-k routing, capacity dispatch, SwiGLU experts
- ``_build``           — nvcc build and ctypes loader for ``csrc/``
"""

from .attention import (attention, flash_attention, flash_bwd, flash_fwd,
                        reference_attention)
from .moe import load_balancing_loss, moe_layer, top_k_routing
from .norms import rms_norm
from .paged_attention import combine_kv, paged_decode, paged_decode_attention
from .ring_attention import ring_attention, ring_attention_local
from .rope import apply_rope, rope_frequencies
from .ulysses import ulysses_attention

__all__ = [
    "rms_norm", "apply_rope", "rope_frequencies",
    "attention", "flash_attention", "flash_fwd", "flash_bwd",
    "reference_attention",
    "combine_kv", "paged_decode", "paged_decode_attention",
    "ring_attention", "ring_attention_local", "ulysses_attention",
    "moe_layer", "top_k_routing", "load_balancing_loss",
]
