"""The share of the traced sub-window in which no operation ran on the
card while training, %: the host's work around the graph replays
(``training.make_scan_epoch``), the augmentation and the saves."""

from benchmark import trace


def read(prof):
    return trace.idle_pct(prof)
