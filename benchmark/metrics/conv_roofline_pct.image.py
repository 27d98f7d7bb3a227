"""The image VAE's convolutions' share of their roofline: the least time
of every forward, dgrad and wgrad in the traced sub-window
(``counts.image``), over the cuDNN convolution kernels' device time, %."""

from benchmark import trace_image


def read(prof):
    return trace_image.conv_roofline_pct(prof)
