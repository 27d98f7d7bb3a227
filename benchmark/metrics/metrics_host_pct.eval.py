"""The share of the traced sub-window's wall spent in the metrics
(``evaluation.evaluate_mmvae`` → ``evaluation.metrics``, numpy on the
host), %."""

from benchmark import trace


def read(prof):
    return trace.window_share(prof, "bench.metrics")
