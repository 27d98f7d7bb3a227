"""The share of the traced sub-window in the reconstruction suite's host
work, %: the port's ``eval.suite`` span outside each chunk's stretch from
its ``eval.forward`` start to its ``eval.wait`` end (``evaluation.harness``:
the lead-in, the host copies and the slicing between chunks, the
concatenation, unpadding and denormalisation after the last)."""

from benchmark import port_spans


def read(prof):
    return port_spans.suite_host_pct(prof)
