"""Shared helper of the PyTorch port's parity tests."""

import jax
import jax.numpy as jnp

from vaesne_tpu_torch.utils.weights import torch_key


def jax_params_from(tm, jm, example):
    """The flax parameter tree of ``jm`` (structure from an abstract init,
    no compile) filled with the torch model's weights."""
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda x: jm.init({"params": key, "sample": key}, x, 1),
                            example)
    state = tm.state_dict()

    def leaf(path, _):
        names = tuple(p.key for p in path)
        value = state[torch_key(names[1:])].numpy()
        return jnp.asarray(value.T if names[-1] == "kernel" else value)

    return jax.tree_util.tree_map_with_path(leaf, shapes)
