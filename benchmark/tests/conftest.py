"""Fixtures of the benchmark's own tests: a cell at a size the CPU holds."""

from __future__ import annotations

import copy
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the CPU's stand-in sizes: 256 spectrum bins keep the decoder's self-attention
# on the kernels' route (and their hash dropout), as 982 bins do on the card
TINY = dict(spectrum_bins=256, photometry_points=12, synthetic_events=24)


@pytest.fixture
def tiny_cell():
    """``make(workload, seed, **traffic_overrides)``: the cell as ``run.py``
    builds it, on the CPU, with the configuration cut to ``TINY`` (batch 4,
    2 of 12 events at K = 8; no repeat) and the evaluated K to 8."""
    import torch

    from benchmark import core
    from benchmark.run import Cell

    def make(workload, seed=2 ** 31 + 12345, seconds=0.2, **traffic_overrides):
        _, config, traffic, limits = core.cell_files(core.spec(), workload)
        config = copy.deepcopy(config)
        config.update(TINY)
        config.pop("repeat_factor", None)
        if config["train"]["K"] > 2:  # as many decoder rows a step as at K = 2, fewer steps
            config.update(synthetic_events=12)
            config["train"]["batch_size"] = 2
        else:
            config["train"]["batch_size"] = 4
        traffic = dict(traffic)
        if traffic["driver"] != "train_loop":
            traffic.update(K=8, chunk=8, check_events=3)
        traffic.update(traffic_overrides)
        return Cell(workload, seed, seconds, False, config, traffic, limits, torch,
                    torch.device("cpu"), core.Spans(), t_start=time.perf_counter())

    return make


@pytest.fixture
def card():
    """The CUDA card, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)
