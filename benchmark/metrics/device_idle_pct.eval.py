"""The share of the traced sub-window in which no operation ran on the
card in the evaluation passes, %."""

from benchmark import trace


def read(prof):
    return trace.idle_pct(prof)
