"""Device ms a batch under the program's sampler ranges (``…/sample``:
the uniform r and the Gaussian y; ``…/challenge``: the challenge's draws
and K4), from the traced window."""

from zkbench.spans import per_batch


def read(obs):
    return per_batch(obs.trace, ("sample", "challenge"))
