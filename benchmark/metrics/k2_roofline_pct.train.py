"""K2's share of its roofline in training (``ops.attention`` →
``csrc/attention_bwd.cu``), %."""

from benchmark import trace


def read(prof):
    return trace.roofline_pct(prof, "K2", "attention_bwd_kernel")
