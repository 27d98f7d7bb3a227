"""The model FLOPs of the training steps completed in the traced
sub-window over its wall time times the card's peak, %."""

from benchmark import trace


def read(prof):
    return trace.mfu_pct(prof)
