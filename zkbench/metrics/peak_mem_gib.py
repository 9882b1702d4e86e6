"""torch.cuda.max_memory_allocated() over the window, after a reset at its
start, in GiB; the largest over the ranks of a multi-card cell."""

from zkbench.core import GIB


def read(obs):
    return obs.peak_bytes / GIB if obs.peak_bytes else None
