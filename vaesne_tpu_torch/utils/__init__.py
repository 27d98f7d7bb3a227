"""Weight utilities of the port."""

from .weights import init_params, load_jax_params

__all__ = ["init_params", "load_jax_params"]
