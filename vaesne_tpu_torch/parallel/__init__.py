"""Multi-GPU over ``torch.distributed``: the mesh, its ranks and Megatron
tensor parallelism (the counterpart of ``vaesne_tpu/parallel``)."""

from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    current_mesh,
    launch,
    make_mesh,
    replicate_state,
    resolve_mesh,
    shard_batch,
    shard_data_parallel,
    shard_of,
)
from .tp import gather_state_tp, shard_params_tp, shard_state_tp, tensor_parallel_specs

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "Mesh", "current_mesh", "gather_state_tp", "launch",
    "make_mesh", "replicate_state", "resolve_mesh", "shard_batch", "shard_data_parallel",
    "shard_of", "shard_params_tp", "shard_state_tp", "tensor_parallel_specs",
]
