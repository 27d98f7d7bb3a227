"""The port's counters, read and moved together.

Each kernel wrapper adds one to its counter where it launches its kernel:
K1 ``attention.launches`` (and ``dropout_launches`` at a rate > 0,
``pipelined_launches`` where the launch took the pipelined fp32 kernel), K2
``attention.bwd_launches`` (and ``bwd_pipelined_launches`` where it took
the pipelined fp32 kernel), K3 ``laplace.launches``, K4
``laplace.bwd_launches``, LN ``layer_norm.launches`` and LN bwd
``layer_norm.bwd_launches``; LN plain (``layer_norm.plain_calls``) counts
the CUDA LayerNorms that computed ``F.layer_norm`` instead; conv
(``conv_launches``, added by ``nn.layers.conv2d``) the convolutions of the
image towers, one a call (cuDNN on the card); ctx attn (``ctx_attn_calls``,
added by ``nn.layers.TransformerBlock``) the blocks' context
self-attentions, one a call (remat's re-run is a call). A CUDA graph's
replay runs no wrapper, so the train step's graph
(``training.make_scan_epoch``) takes the launches its capture recorded off
the counters and adds them back at every replay.
``captures`` counts the CUDA graphs of the train step captured since
import; a replay leaves it as it is.
"""

from __future__ import annotations

import sys
from typing import Dict, Mapping

from . import attention, laplace, layer_norm

captures = 0
conv_launches = 0
ctx_attn_calls = 0

COUNTERS = {"K1": (attention, "launches"), "K1 rate>0": (attention, "dropout_launches"),
            "K1 pipelined": (attention, "pipelined_launches"),
            "K2": (attention, "bwd_launches"),
            "K2 pipelined": (attention, "bwd_pipelined_launches"), "K3": (laplace, "launches"),
            "K4": (laplace, "bwd_launches"), "LN": (layer_norm, "launches"),
            "LN bwd": (layer_norm, "bwd_launches"), "LN plain": (layer_norm, "plain_calls"),
            "captures": (sys.modules[__name__], "captures"),
            "conv": (sys.modules[__name__], "conv_launches"),
            "ctx attn": (sys.modules[__name__], "ctx_attn_calls")}


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
