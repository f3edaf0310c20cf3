"""Ops layer of the port: plain PyTorch building blocks and the hand-written
Hopper kernels of the serving and training paths.

- ``norms``/``rope``   — plain PyTorch (the JAX package leaves them to XLA)
- ``attention``        — causal (GQA) attention: CUDA flash forward
                         (``csrc/flash_fwd.cu``) and backward
                         (``csrc/flash_bwd.cu``), and their plain versions
- ``paged_attention``  — decode attention over the paged KV cache: CUDA
                         paged decode (``csrc/paged_decode.cu``) and its plain
                         version
- ``_build``           — nvcc build and ctypes loader for ``csrc/``
"""

from .attention import (attention, flash_attention, flash_bwd, flash_fwd,
                        reference_attention)
from .norms import rms_norm
from .paged_attention import combine_kv, paged_decode, paged_decode_attention
from .rope import apply_rope, rope_frequencies

__all__ = [
    "rms_norm", "apply_rope", "rope_frequencies",
    "attention", "flash_attention", "flash_fwd", "flash_bwd",
    "reference_attention",
    "combine_kv", "paged_decode", "paged_decode_attention",
]
