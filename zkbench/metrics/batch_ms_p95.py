"""The 95th percentile of every batch of the window, each from its launch
to its synchronised verdicts (in a multi-card cell: every step on rank 0,
its all-reduce included)."""

from zkbench.core import quantile


def read(obs):
    return quantile(obs.batch_ms, 0.95) if obs.batch_ms else None
