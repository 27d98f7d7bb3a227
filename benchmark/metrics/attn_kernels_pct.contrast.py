"""K1's and K2's share of the device's busy time while training the
contrastive towers, %. In this cell they run the spectra tower's masked
983x983 context self-attention alone (the driver holds their launches to
that plan); the branch's projections, its LayerNorm and its dropout run in
other kernels and are not in this share."""

from benchmark import trace


def read(prof):
    return trace.busy_share(prof, "attention_fwd_kernel", "attention_bwd_kernel")
