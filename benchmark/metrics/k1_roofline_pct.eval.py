"""K1's share of its roofline in the evaluation suite
(``csrc/attention_fwd.cu``), %."""

from benchmark import trace


def read(prof):
    return trace.roofline_pct(prof, "K1", "attention_fwd_kernel")
