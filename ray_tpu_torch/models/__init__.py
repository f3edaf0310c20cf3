"""Model zoo of the port: the dense Llama family, in the JAX layout."""

from .convert import opt_state_from_numpy, params_from_numpy
from .llama import (LlamaConfig, forward, forward_with_aux, init_params,
                    llama_125m, llama_1b, llama_7b, llama_tiny, loss_fn,
                    num_params)

__all__ = [
    "LlamaConfig", "init_params", "forward", "forward_with_aux", "loss_fn",
    "num_params", "llama_tiny", "llama_125m", "llama_1b", "llama_7b",
    "params_from_numpy", "opt_state_from_numpy",
]
