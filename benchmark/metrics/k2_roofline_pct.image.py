"""K2's share of its roofline while training the image VAE
(``csrc/attention_bwd.cu``), %."""

from benchmark import trace_image


def read(prof):
    return trace_image.attention_roofline_pct(prof, "K2", "attention_bwd_kernel")
