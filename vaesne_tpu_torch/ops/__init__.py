"""Hand-written CUDA kernels of the port, their plain versions and the
dispatch rule that sends a layer to them."""

from .attention import attention_reference, fused_attention
from .dispatch import env_flag, routes_to_kernel

__all__ = ["attention_reference", "env_flag", "fused_attention", "routes_to_kernel"]
