"""K1's share of its roofline while training the image VAE (the hybrid
decoder's unmasked 900x900 self-attention, ``csrc/attention_fwd.cu``): the
least time of the launches the dispatch rule predicts, over their device
time, %."""

from benchmark import trace_image


def read(prof):
    return trace_image.attention_roofline_pct(prof, "K1", "attention_fwd_kernel")
