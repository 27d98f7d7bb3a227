"""The kernels' launch counters, read and moved together.

Each wrapper adds one to its counter where it launches its kernel: K1
``attention.launches`` (and ``dropout_launches`` at a rate > 0), K2
``attention.bwd_launches``, K3 ``laplace.launches``, K4
``laplace.bwd_launches``. A CUDA graph's replay runs no wrapper, so the
train step's graph (``training.make_scan_epoch``) takes the launches its
capture recorded off the counters and adds them back at every replay.
"""

from __future__ import annotations

from typing import Dict, Mapping

from . import attention, laplace

COUNTERS = {"K1": (attention, "launches"), "K1 rate>0": (attention, "dropout_launches"),
            "K2": (attention, "bwd_launches"), "K3": (laplace, "launches"),
            "K4": (laplace, "bwd_launches")}


def launch_counts() -> Dict[str, int]:
    """Every counter by its kernel's name."""
    return {name: getattr(module, attr) for name, (module, attr) in COUNTERS.items()}


def set_launch_counts(counts: Mapping[str, int]) -> None:
    """Set the named counters."""
    for name, value in counts.items():
        module, attr = COUNTERS[name]
        setattr(module, attr, value)


def add_launch_counts(delta: Mapping[str, int]) -> None:
    """Add ``delta`` to the named counters (a replay's launches)."""
    set_launch_counts({name: getattr(*COUNTERS[name]) + n for name, n in delta.items()})
