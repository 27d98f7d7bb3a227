"""Evaluation of the port: metrics (residual/coverage/width/MSE per phase)
and the chunked inference harness replacing the SLURM eval arrays."""

from .metrics import (
    PHASE_BUCKETS,
    aggr_phase,
    aggregate_metrics,
    get_metric,
    regression_abs_error_in_sigma,
)
from .harness import (
    batched_apply,
    evaluate_mmvae,
    masking_sweep,
    mmvae_reconstruction_suite,
)

__all__ = [
    "PHASE_BUCKETS",
    "aggr_phase",
    "aggregate_metrics",
    "get_metric",
    "regression_abs_error_in_sigma",
    "batched_apply",
    "evaluate_mmvae",
    "masking_sweep",
    "mmvae_reconstruction_suite",
]
