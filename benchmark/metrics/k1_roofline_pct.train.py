"""K1's share of its roofline in training (``ops.attention`` →
``csrc/attention_fwd.cu``): the least time of the launches the dispatch
rule predicts, over their device time, %."""

from benchmark import trace


def read(prof):
    return trace.roofline_pct(prof, "K1", "attention_fwd_kernel")
