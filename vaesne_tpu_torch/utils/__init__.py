"""Weight and seed utilities of the port."""

from .rng import fold_in
from .weights import init_params, load_jax_params, to_jax_params

__all__ = ["fold_in", "init_params", "load_jax_params", "to_jax_params"]
