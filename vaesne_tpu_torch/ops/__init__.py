"""Hand-written CUDA C++ kernels of the port, their plain versions and the
dispatch rules that send a layer to them."""

from .attention import (
    attend,
    attention_backward_reference,
    attention_reference,
    attention_weights,
    fused_attention,
    fused_attention_bwd,
    fused_attention_fwd,
)
from .dispatch import env_flag, laplace_routes_to_kernel, routes_to_kernel
from .laplace import masked_laplace_loglik, masked_laplace_loglik_reference

__all__ = [
    "attend", "attention_backward_reference", "attention_reference", "attention_weights",
    "env_flag", "fused_attention",
    "fused_attention_bwd", "fused_attention_fwd", "laplace_routes_to_kernel",
    "masked_laplace_loglik", "masked_laplace_loglik_reference", "routes_to_kernel",
]
