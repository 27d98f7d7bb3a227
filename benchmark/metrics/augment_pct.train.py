"""The share of the traced sub-window's wall spent in the epochs'
augmentation (``data.augment_multimodal``, called by
``experiments.common.train_loop`` once an epoch), %."""

from benchmark import trace


def read(prof):
    return trace.window_share(prof, "bench.augment")
