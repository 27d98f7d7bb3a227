"""The port's counters, read and moved together.

Each kernel wrapper adds one to its counter where it launches its kernel:
K1 ``attention.launches`` (and ``dropout_launches`` at a rate > 0), K2
``attention.bwd_launches``, K3 ``laplace.launches``, K4
``laplace.bwd_launches``. A CUDA graph's replay runs no wrapper, so the
train step's graph (``training.make_scan_epoch``) takes the launches its
capture recorded off the counters and adds them back at every replay.
``captures`` counts the CUDA graphs of the train step captured since
import; a replay leaves it as it is.
"""

from __future__ import annotations

import sys
from typing import Dict, Mapping

from . import attention, laplace

captures = 0

COUNTERS = {"K1": (attention, "launches"), "K1 rate>0": (attention, "dropout_launches"),
            "K2": (attention, "bwd_launches"), "K3": (laplace, "launches"),
            "K4": (laplace, "bwd_launches"), "captures": (sys.modules[__name__], "captures")}


def launch_counts() -> Dict[str, int]:
    """Every counter by its name: the kernels' launches and ``captures``."""
    return {name: getattr(module, attr) for name, (module, attr) in COUNTERS.items()}


def set_launch_counts(counts: Mapping[str, int]) -> None:
    """Set the named counters."""
    for name, value in counts.items():
        module, attr = COUNTERS[name]
        setattr(module, attr, value)


def add_launch_counts(delta: Mapping[str, int]) -> None:
    """Add ``delta`` to the named counters (a replay's launches)."""
    set_launch_counts({name: getattr(*COUNTERS[name]) + n for name, n in delta.items()})
