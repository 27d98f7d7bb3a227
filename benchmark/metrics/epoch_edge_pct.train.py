"""The share of the traced sub-window at the epochs' edges, %: from each
epoch's mean-loss read (the port's ``train.loss_read`` span) to the start
of the next epoch's first graph replay (``train.replay``), when the card
has no step queued: the callback, the augmentation, a save, the next
order, the first step's host work."""

from benchmark import port_spans


def read(prof):
    return port_spans.epoch_edge_pct(prof)
