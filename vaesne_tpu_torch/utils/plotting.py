"""Plots of the port: the per-epoch loss curve ``train_loop`` saves.

The counterpart of ``vaesne_tpu/utils/plotting.py``'s ``plot_loss_curve``,
with the same lazy import: ``matplotlib`` is imported at the call, so a
host without it (the H100 machine has none) imports the port all the same
and the call raises ImportError.
"""

from __future__ import annotations

import numpy as np


def plot_loss_curve(losses, path=None, ax=None):
    import matplotlib.pyplot as plt

    fig = None
    if ax is None:
        fig, ax = plt.subplots()
    ax.plot(np.arange(len(losses)), np.asarray(losses))
    ax.set_xlabel("training epochs")
    ax.set_ylabel("loss")
    if path is not None and fig is not None:
        fig.savefig(path)
        plt.close(fig)
    return fig
