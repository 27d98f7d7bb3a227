"""The LayerNorm kernels' share of the device's busy time (forward, the
input gradient and the γ/β gradient; ``nn.layers.TransformerBlock``), %."""

from benchmark import trace

LAYERNORM = ("layer_norm", "GammaBeta")  # kernel names of its forward and backward


def read(prof):
    return trace.busy_share(prof, *LAYERNORM)
