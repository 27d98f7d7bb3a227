"""The cuDNN convolutions' share of the device's busy time while training
the image VAE (``nn.layers.conv2d``: the patch convolution and the hybrid
decoder's two refinements, forward, dgrad and wgrad), %; read only where
the trace's forward convolutions are as many as the ``conv`` counter
counted."""

from benchmark import trace_image


def read(prof):
    return trace_image.conv_pct(prof)
