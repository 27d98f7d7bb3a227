"""The share of the traced sub-window in the saves, %: the port's
``train.save`` span over ``experiments.common.train_loop``'s whole save
block (the gather, the checkpoint, ``losses.npy``, ``progress.json``, the
loss plot). A part of ``epoch_edge_pct.train``."""

from benchmark import port_spans


def read(prof):
    return port_spans.save_pct(prof)
